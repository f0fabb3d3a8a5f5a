"""The denoiser trainer's batch data parallelism on the CPU: worlds of 2 and
4 gloo ranks against the port on one device and against the JAX package's
``dp_sharding`` step on the virtual CPU devices of tests/conftest.py.

Each world is started once, in a module fixture, and runs every case of
this file (``parallel.selfcheck.dp_world``); the parent compares. The
model is the CNN at widths (8, 16) on 32x32 patches, its weights carried
over from JAX's ``create_state(key(0), ...)`` by ``convert``; the batches
are tests/test_torch_train.py's.

Tolerances:

- the split against one device, and against JAX's split: each step's loss
  rtol 1e-5; weights, momentum buffers and BatchNorm's running statistics
  rtol 1e-4 / atol 1e-6 (tests/test_train.py's bound for JAX's own split
  against one device). Measured: losses within 2.7e-7, every tensor of
  the states within 5.1e-6 of its largest value;
- the first step's weight gradients (summed over the ranks) against one
  device's: within 1e-4 of each tensor's largest |gradient|, elementwise
  (measured: 6.3e-6). The control: statistics taken as constants are off
  by 6.9 of a tensor's largest gradient, and each patch normalised by its
  own statistics (4 ranks with rank-local BatchNorm) by 1.1;
- every rank's losses and state are rank 0's, bit for bit.
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

from pathtrace_tpu_torch import train
from pathtrace_tpu_torch.convert import train_state_from_flax
from pathtrace_tpu_torch.models import DenoiseCNN
from pathtrace_tpu_torch.parallel.dryrun import dryrun_multichip
from pathtrace_tpu_torch.parallel.launch import launch
from pathtrace_tpu_torch.parallel.selfcheck import dp_world

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (8, 16)
FLAX_TINY = FlaxDenoiseCNN(widths=WIDTHS)
SHAPE = (32, 32, 14)
N_PATCHES = 24
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
GRAD_SHARE = 1e-4
# (world size, batch size): 2 and 4 ranks on a batch of 8, and a batch of 4
# over 4 ranks (one patch a rank: a rank's own variance of one patch is not
# the batch's).
STEP_CASES = [(2, 8), (4, 8), (4, 4)]
EPOCH_BATCH = 8
FIT_EPOCHS = 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(N_PATCHES,) + SHAPE).astype(np.float32)
    y = np.clip(x[..., 0:3] * (0.00316 + x[..., 6:9]), 0, 1).astype(np.float32)
    return x, y


def _flax_tree(state):
    f = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=f(state.params), batch_stats=f(state.batch_stats),
                trace=f(state.opt_state.inner_state[0].trace), lr=np.asarray(state.lr),
                best_loss=np.asarray(state.best_loss),
                plateau_count=np.asarray(state.plateau_count), epoch=np.asarray(state.epoch))


@pytest.fixture(scope="module")
def start():
    """(JAX's TrainState, the port's payload of the same variables)."""
    jstate = jax_train.create_state(jax.random.key(0), FLAX_TINY, SHAPE)
    state = train.create_state(DenoiseCNN(WIDTHS), device="cpu")
    state.load_state_dict(train_state_from_flax(_flax_tree(jstate)))
    return jstate, train.state_payload(state)


def _batches(data, batch_size):
    x, y = data
    return [(torch.from_numpy(x[i: i + batch_size]), torch.from_numpy(y[i: i + batch_size]))
            for i in range(0, 3 * batch_size, batch_size)]


def _perm():
    return np.random.default_rng(5).permutation(N_PATCHES)


def _fit_kwargs(ckpt_dir, epochs):
    return dict(epochs=epochs, batch_size=EPOCH_BATCH, seed=3, log_every=1,
                ckpt_dir=str(ckpt_dir), ckpt_every=1, plateau_patience=0)


@pytest.fixture(scope="module")
def worlds(data, start, tmp_path_factory):
    """Every case on a world of 2 and a world of 4 ranks -> {n: {key: [the
    result of each rank]}}."""
    _, payload = start
    x, y = data
    out = {}
    for n in (2, 4):
        keys, cases = [], []
        keys.append("sharding")
        cases.append(dict(kind="sharding", splits=[(b, None) for b in range(1, 10)]
                          + [(6, [1, 2, 3][:n - 1]), (8, [n - 1, 0])]))
        for world, batch_size in STEP_CASES:
            if world == n:
                keys.append(("steps", batch_size))
                cases.append(dict(kind="steps", model=payload, batches=_batches(data, batch_size)))
        keys.append("epoch")
        cases.append(dict(kind="epoch", model=payload, inputs=torch.from_numpy(x),
                          targets=torch.from_numpy(y), perm=_perm(), batch_size=EPOCH_BATCH))
        if n == 2:
            ckpt = tmp_path_factory.mktemp("dp_fit")
            metrics = str(ckpt / "metrics.jsonl")
            for key, extra in (("fit", dict(model=payload)), ("resume", dict(resume=True))):
                keys.append(key)
                cases.append(dict(kind="fit", inputs=x, targets=y, metrics=metrics,
                                  kwargs=dict(_fit_kwargs(ckpt, FIT_EPOCHS if key == "fit" else 1),
                                              val=(x[:1], y[:1])), **extra))
            out["ckpt"] = ckpt
        by_rank = launch(dp_world, n, cases, device="cpu", quiet=True, timeout_s=300)
        assert [r["rank"] for r in by_rank] == list(range(n))
        assert {r["backend"] for r in by_rank} == {"gloo"}
        out[n] = {key: [r["results"][i] for r in by_rank] for i, key in enumerate(keys)}
    return out


_ONE_DEVICE = {}


def _one_device(payload, batches):
    """The port's single-device steps on the CPU on the whole batches."""
    key = len(batches[0][0])
    if key not in _ONE_DEVICE:
        state = train.state_from_payload(payload, "cpu")
        losses, grads = [], None
        for bx, by in batches:
            losses.append(float(train.train_step(state, bx, by)))
            if grads is None:
                grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        _ONE_DEVICE[key] = {"losses": losses, "grads": grads, "state": state.state_dict()}
    return _ONE_DEVICE[key]


def _assert_states_close(got, want, rtol=RTOL, atol=ATOL):
    """Weights and BatchNorm statistics, and the momentum buffers."""
    for part in ("model", "momentum"):
        assert set(got[part]) == set(want[part])
        for name, ref in want[part].items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[part][name].numpy(), ref.numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{part}: {name}")


def _assert_bit_equal_ranks(results):
    first = results[0]
    for r in results[1:]:
        for key in ("losses", "loss", "history"):
            if key in first:
                assert r[key] == first[key], key
        for part in ("model", "momentum"):
            for name, t in first["state"][part].items():
                assert torch.equal(r["state"][part][name], t), f"{part}: {name}"


def test_dp_sharding_device_choice(worlds):
    """tests/test_train.py's cases: the most devices that divide the batch
    (5 of 8), none for 7 over 4; and the groups a world makes."""
    assert train.dp_devices(5, 8) == 5 and train.dp_devices(8, 8) == 8
    assert train.dp_devices(7, 4) == 1 and train.dp_devices(4, 1) == 1
    assert train.dp_sharding(8) is None  # outside a world: one device
    for n in (2, 4):
        for rank, got in enumerate(worlds[n]["sharding"]):
            *by_batch, sub, pair = got
            for b, split in zip(range(1, 10), by_batch):
                size = train.dp_devices(b, n)
                want = (rank, size) if size > 1 and rank < size else None
                assert split == want, (n, b, rank)
            # devices: the first of the listed ranks that divide the batch
            members = [1, 2, 3][:n - 1][:train.dp_devices(6, n - 1)]
            want = (members.index(rank), len(members)) if len(members) > 1 and rank in members \
                else None
            assert sub == want, (n, rank)
            assert pair == ((0 if rank == 0 else 1, 2) if rank in (0, n - 1) else None)


@pytest.mark.parametrize("n,batch_size", STEP_CASES)
def test_dp_steps_match_one_device(worlds, data, start, n, batch_size):
    """3 steps split over n ranks = 3 steps on one device on the whole batch:
    losses, weights, momentum, running statistics; every rank bit-equal."""
    _, payload = start
    results = worlds[n]["steps", batch_size]
    _assert_bit_equal_ranks(results)
    want = _one_device(payload, _batches(data, batch_size))
    np.testing.assert_allclose(results[0]["losses"], want["losses"], rtol=LOSS_RTOL)
    _assert_states_close(results[0]["state"], want["state"])
    # The statistics moved: more than the initial zeros and ones compared.
    assert float(results[0]["state"]["model"]["block2.BatchNorm_2.running_var"]
                 .sub(1).abs().max()) > 0


@pytest.mark.parametrize("n,batch_size", STEP_CASES)
def test_dp_gradients_match_one_device(worlds, data, start, n, batch_size):
    """The first step's weight gradients, summed over the ranks, are one
    device's: what detached or rank-local BatchNorm statistics break."""
    _, payload = start
    got = worlds[n]["steps", batch_size][0]["grads"]
    want = _one_device(payload, _batches(data, batch_size))["grads"]
    assert set(got) == set(want)
    for name, ref in want.items():
        bound = GRAD_SHARE * float(ref.abs().max())
        err = float((got[name] - ref).abs().max())
        assert err <= bound, f"{name}: {err} > {bound}"


def test_wrong_statistics_would_be_caught(data, start):
    """The control of the gradient test, on one batch of 4: the batch's
    statistics taken as constants (their part of the gradient dropped), and
    each patch normalised by its own statistics (what 4 ranks with
    rank-local BatchNorm compute: the mean of their gradients), move the
    gradients far beyond the test's bound."""
    import pathtrace_tpu_torch.models.denoise_cnn as dc

    _, payload = start
    batches = _batches(data, 4)
    (bx, by) = batches[0]
    want = _one_device(payload, batches)["grads"]

    def step_grads(x, y):
        state = train.state_from_payload(payload, "cpu")
        train.train_step(state, x, y)
        return {k: p.grad for k, p in state.model.named_parameters()}

    def worst(got):
        return max(float((got[k] - w).abs().max()) / float(w.abs().max())
                   for k, w in want.items())

    def constant_statistics(self, x, group=None):
        with torch.no_grad():
            mean, var, _ = dc.batch_stats(x, group)
        return torch.nn.functional.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0,
                                              self.eps)

    saved = dc.BatchNorm.forward
    dc.BatchNorm.forward = constant_statistics
    try:
        detached = step_grads(bx, by)
    finally:
        dc.BatchNorm.forward = saved
    per_rank = [step_grads(bx[i: i + 1], by[i: i + 1]) for i in range(4)]
    rank_local = {k: torch.stack([g[k] for g in per_rank]).mean(0) for k in want}
    assert worst(step_grads(bx, by)) == 0.0
    assert worst(detached) > 100 * GRAD_SHARE
    assert worst(rank_local) > 100 * GRAD_SHARE


def test_dp_steps_match_jax_dp_sharding(worlds, data, start):
    """The same 3 steps on batch 8 against JAX's train_step with the batch
    placed by dp_sharding(8) over 8 virtual CPU devices."""
    jstate, _ = start
    sharding = jax_train.dp_sharding(8)
    assert sharding is not None and sharding.mesh.devices.size == 8
    jlosses = []
    for bx, by in _batches(data, 8):
        jstate, jloss = jax_train.train_step(FLAX_TINY, jstate,
                                             jax.device_put(jnp.asarray(bx.numpy()), sharding),
                                             jax.device_put(jnp.asarray(by.numpy()), sharding))
        jlosses.append(float(jloss))
    want = train_state_from_flax(_flax_tree(jstate))
    for n in (2, 4):
        got = worlds[n]["steps", 8][0]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
        _assert_states_close(got["state"], want)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_train_epoch_matches_one_device(worlds, data, start, n):
    """train_epoch with the split (the --scan-epochs route) = the single-
    device epoch on the same order (tests/test_train.py:203-228)."""
    _, payload = start
    x, y = data
    results = worlds[n]["epoch"]
    _assert_bit_equal_ranks(results)
    state = train.state_from_payload(payload, "cpu")
    loss = train.train_epoch(state, torch.from_numpy(x), torch.from_numpy(y), _perm(),
                             EPOCH_BATCH)
    np.testing.assert_allclose(results[0]["loss"], float(loss), rtol=LOSS_RTOL)
    _assert_states_close(results[0]["state"], state.state_dict())


def test_dp_fit_in_a_world_writes_once_and_resumes(worlds, data, start):
    """fit on 2 ranks: the same history on both, equal to one device's; one
    metrics record an epoch (rank 0 writes, though both ranks opened the
    file), the checkpoints and previews; then a resume from the checkpoint
    continues at epoch 3 on both ranks."""
    _, payload = start
    x, y = data
    fits, resumes, ckpt = worlds[2]["fit"], worlds[2]["resume"], worlds["ckpt"]
    _assert_bit_equal_ranks(fits)
    _assert_bit_equal_ranks(resumes)
    state = train.state_from_payload(payload, "cpu")
    kwargs = _fit_kwargs(ckpt, FIT_EPOCHS)
    del kwargs["ckpt_dir"]
    state, history = train.fit(state, x, y, logger=lambda *a: None, **kwargs)
    np.testing.assert_allclose(fits[0]["history"], history, rtol=LOSS_RTOL)
    _assert_states_close(fits[0]["state"], state.state_dict())
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if r["event"] == "epoch"] == [1, 2, 3]
    assert [r["epoch"] for r in records if r["event"] == "validate"] == [1, 2, 3]
    for name in ("model.json", "model_epoch.pt", "model_best.pt", "best.json", "3_gt.bmp",
                 "3_out.bmp"):
        assert (ckpt / name).is_file(), name
    assert resumes[0]["state"]["epoch"] == 3 and len(resumes[0]["history"]) == 1
    saved = torch.load(ckpt / "model_epoch.pt", weights_only=True)
    assert saved["epoch"] == 3
    for name, t in resumes[0]["state"]["model"].items():
        assert torch.equal(saved["model"][name], t), name


def test_fit_outside_a_world_launches_one(data, start, tmp_path):
    """The route fit takes on a machine with several cards, here on 2 CPU
    ranks: a world is started, and rank 0's state comes back into the
    caller's state, equal to one device's fit."""
    _, payload = start
    x, y = data
    kwargs = _fit_kwargs(tmp_path, 1)
    epochs = kwargs.pop("epochs")
    kwargs.update(val=None, logger=print, scan_epochs=True)
    state = train.state_from_payload(payload, "cpu")
    state, history = train._fit_launched(2, state, x, y, epochs, None, kwargs, device="cpu")
    assert (tmp_path / "model_epoch.pt").is_file()
    kwargs.update(ckpt_dir=None, logger=lambda *a: None)
    ref = train.state_from_payload(payload, "cpu")
    ref, ref_history = train.fit(ref, x, y, epochs, **kwargs)
    np.testing.assert_allclose(history, ref_history, rtol=LOSS_RTOL)
    assert state.epoch == 1 and state.device == torch.device("cpu")
    _assert_states_close(state.state_dict(), ref.state_dict())


def test_dryrun_multichip_runs_the_dp_step():
    out = dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in out] == [0, 1]
    assert all(np.isfinite(r["loss_cnn_dp"]) and r["loss_cnn_dp"] == out[0]["loss_cnn_dp"]
               for r in out)


def test_dryrun_cnn_dp_on_one_device():
    from pathtrace_tpu_torch.parallel.mesh import make_mesh

    assert train.dryrun_cnn_dp(make_mesh(device="cpu")) == pytest.approx(0.0, abs=1e-6)


def _script(name, *args):
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / name), *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_eval_checkpoint_script_on_cpu(tmp_path):
    from pathtrace_tpu_torch.models import init_model

    train.save_checkpoint(str(tmp_path / "run"),
                          init_model(torch.Generator().manual_seed(0), WIDTHS))
    out = _script("torch_eval_checkpoint.py", str(tmp_path / "run"), "--size", "16",
                  "--spp-gt", "8", "--device", "cpu", "--out-prefix", str(tmp_path / "ev"))
    assert "snapshot: model_epoch" in out and "| denoised (epoch None) |" in out
    for kind in ("noisy", "denoised", "gt"):
        assert (tmp_path / f"ev_{kind}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    out = _script("torch_eval_checkpoint.py", str(tmp_path / "run"), "--size", "16",
                  "--spp-gt", "8", "--device", "cpu")
    assert "wrote" not in out and sorted(p.name for p in tmp_path.iterdir()) == [
        "ev_denoised.png", "ev_gt.png", "ev_noisy.png", "run"]


def test_inverse_demo_script_on_cpu(tmp_path):
    out = _script("torch_inverse_demo.py", "--out", str(tmp_path), "--size", "16", "--steps",
                  "2", "--preview-spp", "4", "--backend", "cuda", "--device", "cpu")
    assert out.count(" 2 steps in ") == 3
    md = (tmp_path / "INVERSE.md").read_text()
    for case in ("albedo", "geometry", "glossy"):
        for kind in ("before", "after", "target"):
            assert (tmp_path / f"inverse_{case}_{kind}.png").is_file()
            assert f"inverse_{case}_{kind}.png" in md
    losses = json.loads((tmp_path / "losses.json").read_text())
    assert sorted(losses) == ["albedo", "geometry", "glossy"]
    assert all(len(v) == 2 and np.isfinite(v).all() for v in losses.values())


def test_png_writer_round_trip():
    """The scripts' PNG: 8-bit RGB, unfiltered rows, the BMP writer's clamp
    (255 v); read back with zlib."""
    import struct
    import zlib

    from pathtrace_tpu_torch.io.bmp import encode_bmp
    from pathtrace_tpu_torch.io.png import encode_png

    img = np.random.default_rng(3).uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    assert (w, h, depth, colour) == (7, 5, 8, 2)
    (n,) = struct.unpack(">I", data[33:37])
    assert data[37:41] == b"IDAT"
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(5, 1 + 21)
    assert not rows[:, 0].any()
    want = np.clip(255.0 * img.astype(np.float64), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), want)
    bmp = np.frombuffer(encode_bmp(img)[54:], np.uint8).reshape(5, -1)[:, :21]
    np.testing.assert_array_equal(bmp.reshape(5, 7, 3)[::-1, :, ::-1], want)  # the same bytes
