"""The port's dataset tools against the JAX package's, on the CPU.

The cases of tests/test_data.py on the port, then the two packages side by
side: ``get_patches`` on identical arrays and seeds picks the same patches
(exactly: both are the same numpy code drawing from the generator in the
same order), the pose samplers draw the same poses, ``render_pair`` on the
plain route renders what the JAX package's ``jnp`` route renders on the same
lattice, and the EXR loaders read the same files to the same arrays
(preprocessing within rtol 1e-6: the same f32 divisions and maxima).

The noisy 2-spp image is held to the trace tests' per-channel rules
(``assert_channels_close``). The ground truth takes many samples a pixel,
and a sample whose borderline hit decision goes the other way in one
package moves every mean of its pixel by up to 1/spp of its range (a
normal by 1/80 at 80 spp): the more samples, the more pixels carry one. So
the ground truth is held to the same thresholds on a larger share of
pixels (``assert_ground_truth_close``): colour and its variance off on at
most 10% (measured at 24x24 and 32x32, 80 spp: 5.9% and 3.7%), albedo,
normals and the other statistics on at most 2% (measured 0.7%), depth
within rtol 5e-4 everywhere (4.3e-5). A wrong seed or sample count moves
most pixels.
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu import RenderConfig as JaxRenderConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.data import collect as jax_collect
from pathtrace_tpu.data import loader as jax_loader
from pathtrace_tpu.data import patches as jax_patches

from pathtrace_tpu_torch import RenderConfig, cornell_box
from pathtrace_tpu_torch.data import collect, loader
from pathtrace_tpu_torch.data.collect import collect_dataset, load_poses, random_pose, render_pair
from pathtrace_tpu_torch.data.patches import get_patches, patch_score
from test_torch_trace_kernel import assert_channels_close, flip_share

POSE = (50.0, 52.0, 295.6, -90.0, 0.0)


def test_patch_score_prefers_high_variance():
    flat = np.zeros((8, 8, 14), np.float32)
    noisy = flat.copy()
    noisy[..., 0:6] = np.random.default_rng(0).normal(size=(8, 8, 6))
    assert patch_score(noisy) > patch_score(flat)


def test_get_patches_shapes_and_alignment():
    rng = np.random.default_rng(1)
    data = rng.uniform(size=(64, 64, 14)).astype(np.float32)
    gt = data[..., :3] * 2.0
    px, py = get_patches(data, gt, patch_size=16, num_patches=5, rng=rng)
    assert px.shape == (5, 16, 16, 14)
    assert py.shape == (5, 16, 16, 3)
    # Alignment: gt patch is exactly 2x the color channels of its input.
    np.testing.assert_allclose(py, px[..., :3] * 2.0, rtol=1e-6)


def test_get_patches_importance_bias():
    """Patches from the high-variance half must dominate the selection."""
    rng = np.random.default_rng(2)
    data = np.zeros((64, 128, 14), np.float32)
    data[:, 64:, 0:6] = rng.normal(size=(64, 64, 6))  # right half noisy
    gt = data[..., :3]
    px, _ = get_patches(data, gt, patch_size=8, num_patches=40, rng=rng)
    noisy_fraction = np.mean([patch_score(p) > 1e-8 for p in px])
    assert noisy_fraction > 0.8


def test_patch_too_large_raises():
    with pytest.raises(ValueError, match="smaller than patch"):
        get_patches(np.zeros((8, 8, 14)), np.zeros((8, 8, 3)), patch_size=8, num_patches=1)


@pytest.mark.parametrize("seed,shape,patch,n", [
    (0, (64, 64), 16, 5),
    (1, (48, 80), 8, 12),
    (2, (33, 65), 32, 1),
    (3, (64, 64), 16, 0),  # an all-zero image: uniform picks
])
def test_get_patches_picks_what_jax_picks(seed, shape, patch, n):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape + (14,)).astype(np.float32)
    if n == 0:
        data[:] = 0.0
        n = 6
    gt = rng.uniform(size=shape + (3,)).astype(np.float32)
    ours, theirs = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    got = get_patches(data, gt, patch, n, rng=ours)
    want = jax_patches.get_patches(data, gt, patch, n, rng=theirs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The generators were drawn from alike: what comes next is the same.
    assert ours.integers(1 << 30) == theirs.integers(1 << 30)
    for p in got[0]:
        assert patch_score(p) == jax_patches.patch_score(p)


def test_random_pose_ranges_and_draws():
    rng, ref = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        pose = random_pose(rng)
        x, y, z, yaw, pitch = pose
        assert 0 <= x <= 90 and 0 <= y <= 175 and 0 <= z <= 500
        assert 0 <= yaw <= 360 and -89 <= pitch <= 89
        assert pose == jax_collect.random_pose(ref)


def test_load_poses(tmp_path):
    p = tmp_path / "poses.txt"
    p.write_text("50 52 295.6 -90 0\n10 20 30 40 -5\n")
    poses = load_poses(str(p))
    assert poses.shape == (2, 5)
    assert poses[1, 4] == -5


def assert_ground_truth_close(got, ref):
    """[H, W, 14] many-sample frames: the trace rules' thresholds on the
    shares of pixels stated in the module docstring."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert (np.abs(got[..., 6:9] - ref[..., 6:9]).max(-1) > 0).mean() <= 0.02
    assert (np.abs(got[..., 3:6] - ref[..., 3:6]).max(-1) > 2e-6).mean() <= 0.02
    np.testing.assert_allclose(got[..., 9], ref[..., 9], rtol=5e-4)
    assert flip_share(got[..., 0:3], ref[..., 0:3]) <= 0.10
    for k, share in ((10, 0.10), (11, 0.02), (12, 0.02), (13, 0.02)):
        assert flip_share(got[..., k], ref[..., k], float(np.abs(ref[..., k]).max())) <= share, k


@pytest.mark.parametrize("spp_gt", [16, 80], ids=["one-chunk", "chunked"])
def test_render_pair_matches_jax(spp_gt):
    """The same derived configs (spp_train; spp_gt in chunks of 64 with seed
    + 1): at 80 spp the ground truth is two chunks merged by Chan's formula
    in both packages."""
    cfg = RenderConfig(width=24, height=24, spp=1, backend="torch")
    jcfg = JaxRenderConfig(width=24, height=24, spp=1, backend="jnp")
    noisy, gt = render_pair(cornell_box(), POSE, cfg, spp_train=2, spp_gt=spp_gt, frame=3,
                            device="cpu")
    jnoisy, jgt = jax_collect.render_pair(jax_cornell_box(), POSE, jcfg, spp_train=2,
                                          spp_gt=spp_gt, frame=3)
    assert noisy.shape == gt.shape == (24, 24, 14)
    assert isinstance(noisy, np.ndarray) and isinstance(gt, np.ndarray)
    assert_channels_close(noisy, np.asarray(jnoisy))
    assert_ground_truth_close(gt, jgt)
    # The ground truth's own lattice (seed + 1), not the noisy one's.
    assert flip_share(gt[..., 0:3], np.asarray(jnoisy)[..., 0:3]) > 0.5


def test_render_pair_gt_less_noisy(tmp_path):
    """tests/test_data.py::test_render_pair_and_exr_export on the port."""
    scene = cornell_box()
    cfg = RenderConfig(width=24, height=24, spp=1, backend="torch")
    noisy, gt = render_pair(scene, POSE, cfg, spp_train=2, spp_gt=16, device="cpu")
    ref = render_pair(scene, POSE, cfg, spp_train=2, spp_gt=64, device="cpu")[1][..., 0:3]
    assert np.abs(gt[..., 0:3] - ref).mean() < np.abs(noisy[..., 0:3] - ref).mean()
    noisies, gts = collect_dataset(scene, [POSE], cfg, spp_train=1, spp_gt=2,
                                   save_dir=str(tmp_path), device="cpu")
    assert (tmp_path / "0_train.exr").exists() and (tmp_path / "0_gt.exr").exists()
    np.testing.assert_array_equal(loader.load_exr_channels(tmp_path / "0_train.exr"), noisies[0])
    np.testing.assert_array_equal(loader.load_exr_channels(tmp_path / "0_gt.exr"), gts[0])


@pytest.fixture(scope="module")
def exr_dir(tmp_path_factory):
    """Three EXR pairs written by the JAX package (its layout and names)."""
    path = tmp_path_factory.mktemp("exr")
    poses = [POSE, (40.0, 50.0, 250.0, -80.0, 5.0), (60.0, 45.0, 200.0, -100.0, -5.0)]
    jax_collect.collect_dataset(jax_cornell_box(), poses,
                                JaxRenderConfig(width=40, height=32, spp=1, backend="jnp"),
                                spp_train=1, spp_gt=2, save_dir=str(path))
    return path


def test_loader_reads_what_jax_reads(exr_dir):
    for name in ("0_train.exr", "2_gt.exr"):
        np.testing.assert_array_equal(loader.load_exr_channels(exr_dir / name),
                                      jax_loader.load_exr_channels(exr_dir / name))
    x, y = loader.load_exr_training_pair(exr_dir / "1_train.exr", exr_dir / "1_gt.exr")
    jx, jy = jax_loader.load_exr_training_pair(exr_dir / "1_train.exr", exr_dir / "1_gt.exr")
    assert x.shape == (32, 40, 14) and y.shape == (32, 40, 3)
    np.testing.assert_allclose(x, jx, rtol=1e-6)
    np.testing.assert_allclose(y, jy, rtol=1e-6)


def test_get_dataset_from_dir_matches_jax(exr_dir, tmp_path):
    got = loader.get_dataset_from_dir(str(exr_dir), patch_size=8, patches_per_image=4, seed=2)
    want = jax_loader.get_dataset_from_dir(str(exr_dir), patch_size=8, patches_per_image=4,
                                           seed=2)
    assert got[0].shape == (12, 8, 8, 14) and got[2].shape == (1, 32, 40, 14)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    with pytest.raises(FileNotFoundError, match="no 0_train.exr"):
        loader.get_dataset_from_dir(str(tmp_path))


def test_collect_main_on_cpu(tmp_path, capsys):
    poses = tmp_path / "poses.txt"
    poses.write_text("50 52 295.6 -90 0\n40 50 250 -80 5\n")
    out = tmp_path / "data"
    assert collect.main(["--list", str(poses), "--samples-train", "1", "--samples-gt", "2",
                         "--size", "16", "--out", str(out), "--device", "cpu"]) == 0
    assert "wrote 2 train/gt EXR pairs" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["0_gt.exr", "0_train.exr", "1_gt.exr",
                                                     "1_train.exr"]
    x, y = loader.load_exr_training_pair(out / "1_train.exr", out / "1_gt.exr")
    assert x.shape == (16, 16, 14) and y.shape == (16, 16, 3) and np.isfinite(x).all()
    assert torch.from_numpy(y).min() >= 0 and torch.from_numpy(y).max() <= 1
