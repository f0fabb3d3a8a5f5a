"""The frozen copies against the program's plain versions, at 16x16x2 on
the CPU: the lattice, the camera walk, the tracer (each sample to the bit,
the frame buffer within f32 rounding) and the FPN (eval forward, training
loss and gradients)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.reference import camera as ref_camera
from benchmark.reference import fpn, lattice, tracer

SIZE, SPP, SEED, FRAME = 16, 2, 2**31 + 977, 41


def _port_frame(nee: bool, pose):
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch.ops import trace_kernel as tk

    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, seed=SEED, nee=nee, backend="cuda")
    cam = Camera.create(pose[:3], pose[3], pose[4])
    sb, cb, _ = tk.device_blocks(cornell_box(), cam, cfg, "cpu")
    return cfg, sb, cb, tk


def _ref_frame(nee: bool, pose):
    config = common.load_json("configs", "cornell-nee" if nee else "cornell-diffuse")
    p = ref_camera.Pose(pose[:3], pose[3], pose[4])
    return tracer.Frame(common.spheres(config), p.position, p.corner_rays(SIZE, SIZE), SIZE,
                        SIZE, SEED, FRAME, range(SIZE), light=8 if nee else None), p


def test_lattice_is_the_programs():
    from pathtrace_tpu_torch import rng

    # the kernels take the seed's low 31 bits (trace_kernel.make_seed_block)
    want = rng.sample_uniforms(SEED & 0x7FFFFFFF, FRAME, 3, 4, 5, 5, sample_offset=7, row_offset=2)
    rows = torch.arange(4, dtype=torch.int64)[:, None] + 2
    cols = torch.arange(5, dtype=torch.int64)[None, :]
    pix = lattice.pixel_keys(rows, cols)
    samples = torch.arange(7, 10, dtype=torch.int64)[:, None, None]
    for slot in range(lattice.n_slots(5)):
        got = lattice.uniforms(lattice.base_key(SEED, FRAME), pix, samples, slot,
                               lattice.n_slots(5))
        assert torch.equal(got, want[..., slot])


def test_camera_walk_is_the_programs():
    from pathtrace_tpu_torch import Camera
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.config import RenderConfig

    cam = Camera.create((50.0, 52.0, 295.6), -90.0, 0.0)
    pose = ref_camera.Pose((50.0, 52.0, 295.6), -90.0, 0.0)
    rng = np.random.default_rng(3)
    for i in range(40):
        d = ("forward", "backward", "left", "right")[i % 4]
        dx, dy = (float(v) for v in rng.uniform(-1, 1, 2))
        cam = cam.move(d, 1 / 60).look(dx, dy)
        pose = pose.move(d, 1 / 60).look(dx, dy)
    block = tk.camera_block(cam, RenderConfig(width=64, height=48))
    assert torch.equal(pose.position, block[0])
    assert torch.equal(pose.corner_rays(64, 48), block[1:])


@pytest.mark.parametrize("nee", [False, True])
def test_tracer_is_the_programs(nee):
    from pathtrace_tpu_torch.ops import trace_kernel as tk

    pose = (40.0, 45.0, 250.0, -95.0, 3.0)
    cfg, sb, cb, tk = _port_frame(nee, pose)
    fr, _ = _ref_frame(nee, pose)
    lat = tk.PlainLattice(sb, cb, tk.make_seed_block(cfg, FRAME), cfg, SIZE)
    for s in range(SPP):
        want = lat.sample(s, cfg)
        got = fr.paths(s, 1)
        for w, g in zip(want[0] + want[1] + want[2] + [want[3]],
                        got[0] + got[1] + got[2] + [got[3]]):
            assert torch.equal(w, g[0])
        assert torch.equal(want[4], got[4][0]) and torch.equal(want[5], got[5][0])
    want = tk.trace_plain(sb, cb, tk.make_seed_block(cfg, FRAME), cfg, local_h=SIZE, spp=SPP,
                          mode="channels")
    assert common.channel_gap(tracer.frame_buffer(fr, SPP), want) < 1e-6


def test_tracer_rows_are_the_frames_rows():
    pose = (50.0, 52.0, 295.6, -90.0, 0.0)
    fr, p = _ref_frame(False, pose)
    whole = tracer.frame_buffer(fr, 3)
    rows = tracer.Frame(fr.sp, p.position, p.corner_rays(SIZE, SIZE), SIZE, SIZE, SEED, FRAME,
                        range(5, 9))
    assert torch.equal(tracer.frame_buffer(rows, 3), whole[5:9])


def _port_model(weights, widths):
    from pathtrace_tpu_torch.models.denoise_cnn import DenoiseCNN

    model = DenoiseCNN(widths, fpn.LATERAL)
    model.load_state_dict(common.port_state_dict(weights))
    return model


def test_fpn_forward_is_the_programs(tmp_path):
    from pathtrace_tpu_torch.models.infer import denoise_with, load_pretrained
    from pathtrace_tpu_torch.models.preprocess import preprocess_channels

    widths = (8, 16, 32)
    weights = common.fpn_weights(5, "cpu", widths, fpn.LATERAL)
    common.write_checkpoint(str(tmp_path / "ckpt"), weights, widths, fpn.LATERAL)
    model = load_pretrained(str(tmp_path / "ckpt"), "cpu")
    buf = torch.rand(20, 24, 14)
    assert torch.equal(fpn.preprocess(buf), preprocess_channels(buf))
    want = denoise_with(model, buf)
    got = fpn.forward(weights, fpn.preprocess(buf)[None], widths=widths)[0]
    assert float((got - want).abs().max()) < 1e-5
    assert 0.1 < float(((got > 0) & (got < 1)).float().mean())


def test_fpn_training_step_is_the_programs():
    from pathtrace_tpu_torch import train

    widths = (8, 16)
    weights = common.fpn_weights(6, "cpu", widths, fpn.LATERAL)
    st = train.create_state(_port_model(weights, widths), "cpu")
    x, y = torch.rand(5, 32, 32, 14), torch.rand(5, 32, 32, 3)
    loss = train.train_step(st, x, y)
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    ref = fpn.l1(fpn.forward(p, x, train=True, widths=widths), y)
    names = [k for k, _ in st.model.named_parameters()]
    grads = torch.autograd.grad(ref, [p[k] for k in names])
    assert abs(float(loss) - float(ref)) < 1e-6
    mom = st.momentum()
    for k, g in zip(names, grads):
        assert float((mom[k] - g).abs().max()) <= 1e-5 * max(1.0, float(g.abs().max())), k
