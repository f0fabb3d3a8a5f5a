"""The port's trainer against the JAX package's, on the CPU.

The JAX ``TrainState`` (Flax variables, optax's momentum trace, the plateau
fields) is carried across by ``convert.train_state_from_flax``; then both
packages take the same steps on the same batches. Tolerances, measured at
widths (8, 16) on 32x32 patches: after three SGD steps, parameters, BN
running statistics and momentum buffers within 1e-5 of the largest value of
their tensor plus 1e-6 (measured: 1.2e-7 absolute, 5e-6 of the largest),
each step's loss within rtol 1e-5 (measured 1.5e-6): both are f32 on the
CPU, summing convolutions and the BN reductions in another order. The same
for the 2-epoch ``fit``. The plateau schedule is held exactly: the same f32
learning rate, best loss, count and epoch after every epoch. The port's own
routes (``train_epoch`` against ``loop_epoch``, a resumed state against the
one saved) are held to rtol 1e-6 / atol 1e-7 (the JAX test's bound for its
scanned epoch) or to the bit. Three Adam steps of the simple CNN: the
summed loss within rtol 1e-5 (measured 2.4e-6), every parameter within half
a learning rate of JAX's and at most 0.5% of them beyond 1e-2 of one
(measured: 0.19 and 0.08%). Adam moves each weight by about lr whatever its
gradient's size, so a weight whose gradient is mostly rounding (a sum that
cancels) moves by another fraction of lr in each package; a wrong rule
(no bias correction, another beta) moves most weights by lr or more.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import train as jax_train
from pathtrace_tpu.models.denoise_cnn import DenoiseCNN as FlaxDenoiseCNN
from pathtrace_tpu.models.simple_cnn import create_simple_state as jax_create_simple_state
from pathtrace_tpu.models.simple_cnn import simple_train_step as jax_simple_train_step

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import train
from pathtrace_tpu_torch.convert import simple_state_dict_from_flax, train_state_from_flax
from pathtrace_tpu_torch.data import collect
from pathtrace_tpu_torch.io.bmp import read_bmp
from pathtrace_tpu_torch.models import DenoiseCNN, init_model
from pathtrace_tpu_torch.models.simple_cnn import create_simple_state, simple_train_step
from pathtrace_tpu_torch.utils.metrics import JsonlLogger

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (8, 16)
FLAX_TINY = FlaxDenoiseCNN(widths=WIDTHS)
SHAPE = (32, 32, 14)


@pytest.fixture(scope="module")
def tiny_data():
    """15 patches: the JAX test's learnable target (a clipped product of the
    model's output form)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(15,) + SHAPE).astype(np.float32)
    y = np.clip(x[..., 0:3] * (0.00316 + x[..., 6:9]), 0, 1).astype(np.float32)
    return x, y


def _flax_tree(state):
    """The JAX TrainState as nested numpy dicts, as train_state_from_flax
    takes them."""
    f = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=f(state.params), batch_stats=f(state.batch_stats),
                trace=f(state.opt_state.inner_state[0].trace), lr=np.asarray(state.lr),
                best_loss=np.asarray(state.best_loss),
                plateau_count=np.asarray(state.plateau_count), epoch=np.asarray(state.epoch))


def _pair(seed=0):
    """(JAX state, the port's state on the CPU from the same variables)."""
    jstate = jax_train.create_state(jax.random.key(seed), FLAX_TINY, SHAPE)
    state = train.create_state(DenoiseCNN(WIDTHS), device="cpu")
    state.load_state_dict(train_state_from_flax(_flax_tree(jstate)))
    return jstate, state


def _assert_tensors_close(got, want, rel=1e-5, atol=1e-6):
    """Every tensor of ``want`` (name -> tensor) within rel x its largest
    |value| + atol; BN's batch counters are not state the JAX package has."""
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        bound = rel * float(ref.abs().max()) + atol
        err = float((got[name] - ref).abs().max())
        assert err <= bound, f"{name}: {err} > {bound}"


def _assert_state_matches_jax(state, jstate, **tol):
    want = train_state_from_flax(_flax_tree(jstate))
    got = state.state_dict()
    assert set(got["model"]) == set(want["model"]) and set(got["momentum"]) == set(want["momentum"])
    _assert_tensors_close(got["model"], want["model"], **tol)
    _assert_tensors_close(got["momentum"], want["momentum"], **tol)
    for key in ("lr", "plateau_count", "epoch"):
        assert got[key] == want[key], key
    assert got["best_loss"] == pytest.approx(want["best_loss"], rel=1e-5)  # an epoch's loss


def test_three_train_steps_match_jax(tiny_data):
    x, y = tiny_data
    jstate, state = _pair()
    _assert_state_matches_jax(state, jstate, rel=0.0, atol=0.0)  # converted exactly
    for i in range(3):
        b, t = x[5 * i: 5 * i + 5], y[5 * i: 5 * i + 5]
        jstate, jloss = jax_train.train_step(FLAX_TINY, jstate, jnp.asarray(b), jnp.asarray(t))
        loss = train.train_step(state, torch.from_numpy(b), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _assert_state_matches_jax(state, jstate)
    # The momentum buffers moved (and BN statistics with them): the test
    # compared more than the initial zeros and ones.
    assert all(float(m.abs().max()) > 0 for m in state.momentum().values())
    assert float(state.model.block2.BatchNorm_2.running_var.sub(1).abs().max()) > 0


def test_optimizer_is_nesterov_sgd():
    state = train.create_state(DenoiseCNN(WIDTHS), device="cpu")
    (group,) = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.SGD)
    assert (group["momentum"], group["nesterov"], group["dampening"], group["weight_decay"]) == (
        0.9, True, 0.0, 0.0)
    assert state.lr == float(np.float32(0.01)) and state.epoch == 0
    assert state.best_loss == float("inf") and state.plateau_count == 0


def test_train_step_is_deterministic_and_restores_cudnn_flags(tiny_data, monkeypatch):
    """A step runs cuDNN's deterministic algorithms with TF32 off, and hands
    the caller's settings back; two steps from one state give the same bits."""
    x, y = tiny_data
    seen = []
    real_forward = DenoiseCNN.forward

    def forward(self, *args):
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32))
        return real_forward(self, *args)

    monkeypatch.setattr(DenoiseCNN, "forward", forward)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    states = []
    for _ in range(2):
        state = train.create_state(init_model(torch.Generator().manual_seed(0), WIDTHS), "cpu")
        train.train_step(state, torch.from_numpy(x[:5]), torch.from_numpy(y[:5]))
        states.append(state.state_dict())
    assert seen == [(True, False)] * 2
    assert not torch.backends.cudnn.deterministic and torch.backends.cudnn.allow_tf32
    for part in ("model", "momentum"):
        for k, v in states[0][part].items():
            assert torch.equal(states[1][part][k], v), k


def test_train_step_writes_the_state_lr(tiny_data):
    """The lr of TrainState enters the update (not the optimiser's own)."""
    x, y = tiny_data
    states = []
    for lr in (0.01, 0.0):
        state = train.create_state(init_model(torch.Generator().manual_seed(0), WIDTHS), "cpu")
        state.lr = lr
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        train.train_step(state, torch.from_numpy(x[:5]), torch.from_numpy(y[:5]))
        assert state.optimizer.param_groups[0]["lr"] == lr
        states.append((before, state.model.state_dict()))
    before, after = states[1]  # lr 0: weights unchanged, BN statistics moved
    assert torch.equal(before["rgb_conv.weight"], after["rgb_conv.weight"])
    assert not torch.equal(states[0][0]["rgb_conv.weight"], states[0][1]["rgb_conv.weight"])


# Loss sequences for the plateau schedule (f32 values, patience 2).
CREEP = [1.0 * (1.0 - 5e-5) ** k for k in range(24)]  # 5e-5 better each epoch
PLATEAU_CASES = {
    "creeping": CREEP,
    "flat": [1.0] * 12,
    "improving": [1.0 / (k + 1) for k in range(10)],
    "mixed": [1.0, 0.5, 0.49999, 0.6, 0.5, 0.4, 0.4, 0.39999, 0.41, 0.42, 0.1, 0.1, 0.2, 0.05],
}


@pytest.mark.parametrize("case", list(PLATEAU_CASES))
def test_plateau_sequence_matches_jax(case):
    jstate, state = _pair()
    for loss in PLATEAU_CASES[case]:
        loss = np.float32(loss)
        jstate = jax_train.plateau_update(jstate, jnp.asarray(loss, jnp.float32), patience=2)
        train.plateau_update(state, loss, patience=2)
        want = (float(jstate.lr), float(jstate.best_loss), int(jstate.plateau_count),
                int(jstate.epoch))
        assert (state.lr, state.best_loss, state.plateau_count, state.epoch) == want


def test_creeping_loss_is_not_torchs_reduce_on_plateau():
    """The trap the explicit schedule avoids: torch's scheduler keeps its best
    until a loss beats it by the relative threshold, so on a loss that creeps
    down by less than 1e-4 an epoch its rate falls later than the JAX
    package's."""
    state = train.create_state(DenoiseCNN(WIDTHS), device="cpu")
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        state.optimizer, "min", factor=0.5, patience=2, threshold=1e-4)
    ours, torchs = [], []
    for loss in CREEP:
        ours.append(train.plateau_update(state, loss, patience=2).lr)
        sched.step(loss)
        torchs.append(state.optimizer.param_groups[0]["lr"])
    assert ours != pytest.approx(torchs)
    assert ours[3] == pytest.approx(0.005) and torchs[3] == pytest.approx(0.01)


def test_plateau_scheduler():
    """tests/test_train.py::test_plateau_scheduler on the port, at the
    reference's patience."""
    state = train.create_state(DenoiseCNN(WIDTHS), device="cpu")
    assert state.lr == pytest.approx(train.BASE_LR)
    train.plateau_update(state, 1.0)  # improves (from inf)
    assert state.plateau_count == 0
    for _ in range(train.PLATEAU_PATIENCE + 1):
        train.plateau_update(state, 1.0)  # no improvement
    assert state.lr == pytest.approx(train.BASE_LR * 0.5)
    assert state.plateau_count == 0  # reset after reduction
    assert state.epoch == train.PLATEAU_PATIENCE + 2


def test_eval_step_matches_jax(tiny_data):
    x, y = tiny_data
    jstate, state = _pair()
    jstate, _ = jax_train.train_step(FLAX_TINY, jstate, jnp.asarray(x[:5]), jnp.asarray(y[:5]))
    train.train_step(state, torch.from_numpy(x[:5]), torch.from_numpy(y[:5]))
    jout, jloss, jpsnr = jax_train.eval_step(FLAX_TINY, jstate, jnp.asarray(x[5:7]),
                                             jnp.asarray(y[5:7]))
    out, loss, psnr = train.eval_step(state, torch.from_numpy(x[5:7]), torch.from_numpy(y[5:7]))
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(jpsnr), rtol=1e-5)
    # PSNR from the L1 criterion — the reference's quirk (train.py:43).
    np.testing.assert_allclose(float(psnr), 10 * np.log10(1 / float(loss)), rtol=1e-5)


def test_train_epoch_matches_loop(tiny_data):
    """train_epoch (the dataset where it is, minibatches gathered by index)
    = loop_epoch (minibatches gathered on the host) = train_step in order;
    with 15 patches and a batch of 4 both drop the last 3."""
    x, y = tiny_data
    perm = np.random.default_rng(3).permutation(15)
    states = [train.create_state(init_model(torch.Generator().manual_seed(0), WIDTHS), "cpu")
              for _ in range(3)]
    avg_scan = train.train_epoch(states[0], torch.from_numpy(x), torch.from_numpy(y), perm, 4)
    avg_loop = train.loop_epoch(states[1], x, y, perm, 4)
    losses = [float(train.train_step(states[2], torch.from_numpy(x[perm[i:i + 4]]),
                                     torch.from_numpy(y[perm[i:i + 4]])))
              for i in range(0, 12, 4)]
    np.testing.assert_allclose(float(avg_scan), np.mean(losses), rtol=1e-6)
    assert avg_loop == pytest.approx(np.mean(losses), rel=1e-12)
    for other in states[1:]:
        for (name, a), b in zip(states[0].model.state_dict().items(),
                                other.model.state_dict().values()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_loop_epoch_matches_jax_scanned_epoch(tiny_data):
    """One epoch of the port's loop against JAX's lax.scan epoch on the same
    order."""
    x, y = tiny_data
    perm = np.random.default_rng(4).permutation(15)
    jstate, state = _pair()
    jstate, javg = jax_train.train_epoch(FLAX_TINY, jstate, jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(perm, jnp.int32), 5)
    avg = train.loop_epoch(state, x, y, perm, 5)
    np.testing.assert_allclose(avg, float(javg), rtol=1e-5)
    _assert_state_matches_jax(state, jstate)


def test_checkpoint_roundtrip_with_optimizer_state(tmp_path, tiny_data):
    x, y = tiny_data
    state = train.create_state(init_model(torch.Generator().manual_seed(0), WIDTHS), "cpu")
    train.train_step(state, torch.from_numpy(x[:5]), torch.from_numpy(y[:5]))
    train.plateau_update(state, 0.25)
    state.lr = float(np.float32(0.005))  # the state holds f32 values
    path = train.save_checkpoint(str(tmp_path), state)
    assert path == str(tmp_path / "model_epoch.pt")
    assert json.loads((tmp_path / "model.json").read_text()) == {
        "widths": list(WIDTHS), "lateral_features": 32}
    restored = train.load_train_state(str(tmp_path), device="cpu")
    assert (restored.lr, restored.best_loss, restored.plateau_count, restored.epoch) == (
        state.lr, 0.25, 0, 1)
    for (name, a), b in zip(state.momentum().items(), restored.momentum().values()):
        assert torch.equal(a, b), name
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    # Resumed training continues to the bit.
    # The inference loader reads the same file.
    model = train.load_checkpoint(str(tmp_path))
    assert not model.training
    assert torch.equal(model.rgb_conv.weight, restored.model.rgb_conv.weight)
    l1 = train.train_step(state, torch.from_numpy(x[5:10]), torch.from_numpy(y[5:10]))
    l2 = train.train_step(restored, torch.from_numpy(x[5:10]), torch.from_numpy(y[5:10]))
    assert torch.equal(l1, l2)
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    # A bare model cannot resume.
    train.save_checkpoint(str(tmp_path / "bare"), init_model(torch.Generator().manual_seed(0),
                                                             WIDTHS))
    with pytest.raises(ValueError, match="cannot be resumed"):
        train.load_train_state(str(tmp_path / "bare"), device="cpu")


def test_best_val_checkpoint_retained(tmp_path, tiny_data):
    """Best-validation weights survive later, worse epochs (the reference
    only overwrites model_epoch, denoise_cnn/train.py:68); a resumed fit in
    the same directory keeps the bar."""
    x, y = tiny_data
    state = train.create_state(init_model(torch.Generator().manual_seed(0), WIDTHS), "cpu")
    train.fit(state, x, y, epochs=4, batch_size=5, log_every=0, ckpt_dir=str(tmp_path),
              ckpt_every=2, val=(x[:1], y[:1]))
    assert (tmp_path / "model_best.pt").is_file()
    best = json.loads((tmp_path / "best.json").read_text())
    restored = train.load_train_state(str(tmp_path), name="model_best", device="cpu")
    assert restored.epoch == best["epoch"]
    _, _, psnr = train.eval_step(restored, torch.from_numpy(x[:1]), torch.from_numpy(y[:1]))
    np.testing.assert_allclose(float(psnr), best["psnr_db"], rtol=1e-4)
    for epoch in (2, 4):
        for kind in ("gt", "out"):
            assert read_bmp(tmp_path / f"{epoch}_{kind}.bmp").shape == (32, 32, 3)
    state2 = train.create_state(init_model(torch.Generator().manual_seed(1), WIDTHS), "cpu")
    train.fit(state2, x, y, epochs=2, batch_size=5, log_every=0, ckpt_dir=str(tmp_path),
              ckpt_every=1, val=(x[:1], y[:1]))
    best2 = json.loads((tmp_path / "best.json").read_text())
    assert best2["psnr_db"] >= best["psnr_db"]


def test_fit_matches_jax(tiny_data):
    """Two epochs of fit, the same data and seed: the same shuffles, losses
    and final state (remainder dropped: 15 patches, batch 4)."""
    x, y = tiny_data
    jstate, state = _pair()
    # data_parallel=False: tests/conftest.py gives JAX 8 CPU devices, and JAX's
    # fit would split each batch over them (exact only up to the reduction
    # order); the port's one-device fit is the unsplit semantics.
    jstate, jhist = jax_train.fit(FLAX_TINY, jstate, x, y, epochs=2, batch_size=4, seed=7,
                                  log_every=0, plateau_patience=0, data_parallel=False)
    state, hist = train.fit(state, x, y, epochs=2, batch_size=4, seed=7, log_every=0,
                            plateau_patience=0)
    np.testing.assert_allclose(hist, jhist, rtol=1e-5)
    _assert_state_matches_jax(state, jstate)
    assert state.epoch == 2


def test_fit_jsonl_metrics_read_by_plot_training(tmp_path, tiny_data):
    x, y = tiny_data
    state = train.create_state(init_model(torch.Generator().manual_seed(0), WIDTHS), "cpu")
    path = tmp_path / "metrics.jsonl"
    with JsonlLogger(str(path)) as metrics:
        train.fit(state, x, y, epochs=2, batch_size=5, log_every=0, metrics=metrics,
                  ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, val=(x[:1], y[:1]))
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["epoch"] for r in records if r["event"] == "epoch"] == [1, 2]
    assert [r["epoch"] for r in records if r["event"] == "validate"] == [1, 2]
    assert all("loss" in r and "lr" in r for r in records if r["event"] == "epoch")
    out = tmp_path / "curves.png"
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "plot_training.py"), str(path),
                           "--out", str(out)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "2 epochs, 2 validations" in proc.stdout and out.stat().st_size > 0


def test_build_dataset_matches_jax_on_the_same_renders(monkeypatch):
    """Preprocessing and the patch picks of both packages on the JAX
    package's renders: the same arrays. (The two renderers differ in the last
    bits, and a weighted pick can flip on that: the renders are shared.)"""
    from pathtrace_tpu import RenderConfig as JaxRenderConfig
    from pathtrace_tpu import cornell_box as jax_cornell_box
    from pathtrace_tpu.data import collect as jax_collect

    jcfg = JaxRenderConfig(width=40, height=40, spp=1, backend="jnp")
    poses = [jax_train.interior_pose(np.random.default_rng(5)) for _ in range(2)]
    renders = jax_collect.collect_dataset(jax_cornell_box(), poses, jcfg, spp_train=1, spp_gt=2)
    monkeypatch.setattr(jax_collect, "collect_dataset", lambda *a, **k: renders)
    monkeypatch.setattr(collect, "collect_dataset", lambda *a, **k: renders)
    kw = dict(n_poses=2, patch_size=16, patches_per_image=3, spp_train=1, spp_gt=2, seed=1)
    want = jax_train.build_dataset(None, jcfg, **kw)
    got = train.build_dataset(None, RenderConfig(width=40, height=40), device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_build_dataset_from_renders_on_cpu():
    """tests/test_train.py::test_build_dataset_from_renders on the port (the
    plain route on the CPU), and the pose samplers draw as the JAX ones."""
    cfg = RenderConfig(width=48, height=48, spp=1, backend="torch")
    inputs, targets = train.build_dataset(cornell_box(), cfg, n_poses=2, patch_size=16,
                                          patches_per_image=3, spp_train=1, spp_gt=2, seed=1,
                                          pose_mode="interior", device="cpu")
    assert inputs.shape == (6, 16, 16, 14) and targets.shape == (6, 16, 16, 3)
    assert np.isfinite(inputs).all() and np.isfinite(targets).all()
    assert targets.min() >= 0 and targets.max() <= 1
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        assert train.interior_pose(a) == jax_train.interior_pose(b)


def test_main_on_cpu_then_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--size", "24", "--poses", "2", "--patch-size", "8",
             "--patches-per-image", "3", "--spp-train", "1", "--spp-gt", "2", "--widths", "8,16",
             "--lateral-features", "8", "--ckpt-every", "2", "--plateau-patience", "1"]
    assert train.main(flags + ["--epochs", "2", "--name", "tiny"]) == 0
    (run,) = (tmp_path / "results").iterdir()
    assert run.name.endswith("_tiny")
    out = capsys.readouterr().out
    assert "===> Dataset: (6, 8, 8, 14) -> (6, 8, 8, 3)" in out and "Avg. PSNR" in out
    for name in ("model.json", "model_epoch.pt", "model_best.pt", "best.json", "metrics.jsonl",
                 "2_gt.bmp", "2_out.bmp"):
        assert (run / name).is_file(), name
    saved = torch.load(run / "model_epoch.pt", weights_only=True)
    assert saved["epoch"] == 2
    assert train.main(flags + ["--epochs", "1", "--resume", str(run), "--scan-epochs"]) == 0
    assert "===> Resumed at epoch 2" in capsys.readouterr().out
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if r["event"] == "epoch"] == [1, 2, 3]
    assert torch.load(run / "model_epoch.pt", weights_only=True)["epoch"] == 3


def test_simple_train_step_matches_jax(tiny_data):
    x, y = tiny_data
    jmodel, jparams, jopt, _ = jax_create_simple_state(jax.random.key(0), SHAPE)
    model, opt = create_simple_state(torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(simple_state_dict_from_flax(jax.tree.map(np.asarray, jparams)))
    assert model(torch.from_numpy(x[:1])).shape == (1, 32, 32, 3)
    for i in range(3):
        b, t = x[5 * i: 5 * i + 5], y[5 * i: 5 * i + 5]
        jparams, jopt, jloss = jax_simple_train_step(jmodel, jparams, jopt, jnp.asarray(b),
                                                     jnp.asarray(t))
        loss = simple_train_step(model, opt, torch.from_numpy(b), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = simple_state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    got = model.state_dict()
    lr = 1e-4
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert float(diff.max()) <= 0.5 * lr
    assert float((diff > 1e-2 * lr).float().mean()) <= 0.005


# name -> f(device, tmp_path): one call of a trainer entry point.
ENTRY_POINTS = {
    "create_state": lambda d, t: train.create_state(DenoiseCNN(WIDTHS), d),
    "load_train_state": lambda d, t: train.load_train_state(str(t / "ck"), device=d),
    "build_dataset": lambda d, t: train.build_dataset(
        cornell_box(), RenderConfig(width=20, height=20, spp=1), n_poses=1, patch_size=8,
        patches_per_image=1, spp_train=1, spp_gt=1, device=d),
    "render_pair": lambda d, t: collect.render_pair(
        cornell_box(), (50.0, 52.0, 295.6, -90.0, 0.0), RenderConfig(width=8, height=4),
        1, 1, device=d),
    "collect_dataset": lambda d, t: collect.collect_dataset(
        cornell_box(), [(50.0, 52.0, 295.6, -90.0, 0.0)], RenderConfig(width=8, height=4),
        1, 1, device=d),
    "create_simple_state": lambda d, t: create_simple_state(torch.Generator(), device=d),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_cuda_or_device_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = train.create_state(DenoiseCNN(WIDTHS), "cpu")
    train.save_checkpoint(str(tmp_path / "ck"), state)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[name](None, tmp_path)
    ENTRY_POINTS[name]("cpu", tmp_path)


@pytest.mark.parametrize("main", [train.main, collect.main], ids=["train", "collect"])
def test_clis_need_cuda_or_device_cpu(main, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "poses.txt").write_text("50 52 295.6 -90 0\n")
    assert main(["--list", "poses.txt"] if main is collect.main else ["--epochs", "1"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not list(tmp_path.glob("results")) and not list(tmp_path.glob("data"))


def test_camera_pose_of_render_pair():
    """render_pair's camera is the pose's (x, y, z, yaw, pitch)."""
    cfg = RenderConfig(width=8, height=8, spp=1, max_bounces=1)
    noisy, gt = collect.render_pair(cornell_box(), (10.0, 20.0, 30.0, 40.0, -5.0), cfg, 1, 1,
                                    device="cpu")
    from pathtrace_tpu_torch.render import render_channels

    cam = Camera.create(position=(10.0, 20.0, 30.0), yaw=40.0, pitch=-5.0)
    assert np.array_equal(noisy, render_channels(cornell_box(), cam, cfg, 0, "cpu").numpy())
    assert noisy.shape == gt.shape == (8, 8, 14)


def test_converted_jax_run_resumes_on_the_port(tmp_path, tiny_data):
    """scripts/torch_convert_checkpoint.py carries a JAX run's whole state
    (orbax): the port resumes it where it stopped and its next step is JAX's
    next step."""
    import importlib.util

    x, y = tiny_data
    jstate = jax_train.create_state(jax.random.key(0), FLAX_TINY, SHAPE)
    for i in range(2):
        jstate, _ = jax_train.train_step(FLAX_TINY, jstate, jnp.asarray(x[5 * i: 5 * i + 5]),
                                         jnp.asarray(y[5 * i: 5 * i + 5]))
        jstate = jax_train.plateau_update(jstate, jnp.asarray(0.3, jnp.float32), patience=0)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train.save_checkpoint(jax_dir, jstate, FLAX_TINY)
    spec = importlib.util.spec_from_file_location(
        "torch_convert_checkpoint", REPO / "scripts" / "torch_convert_checkpoint.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.convert(jax_dir, port_dir) == os.path.join(port_dir, "model_epoch.pt")
    state = train.load_train_state(port_dir, device="cpu")
    assert (state.epoch, state.plateau_count, state.lr) == (2, 0, float(np.float32(0.005)))
    _assert_state_matches_jax(state, jstate, rel=0.0, atol=0.0)
    jstate, jloss = jax_train.train_step(FLAX_TINY, jstate, jnp.asarray(x[10:15]),
                                         jnp.asarray(y[10:15]))
    loss = train.train_step(state, torch.from_numpy(x[10:15]), torch.from_numpy(y[10:15]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_state_matches_jax(state, jstate)
