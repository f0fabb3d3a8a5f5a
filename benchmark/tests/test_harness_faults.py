"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run on the CPU at a small size (the
harness's look for a card skipped; the program runs its kernels' plain
versions), once sound and once with one fault planted in the program: a
step that returns its state unchanged, half of the batch left out with the
mean taken over the rest, an answer altered where it is produced. (No cell
spans chips, so none can leave out an exchange between them.) The
controls, the reference in a lower precision in the program's place, read
false too: bf16 on the CPU; TF32, which only the card has, on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
SMALL = {
    "cornell-diffuse.preview": dict(width=24, height=24, widths=(8, 16)),
    "cornell-diffuse.collect": dict(width=16, height=16, spp_gt=32),
    "cornell-nee.inverse_geometry": dict(width=16, height=16, spp=2),
    "cornell-diffuse.train": dict(pool=20, patch=32, widths=(8, 16)),
}
SEED = 2**31 + 4242


def run(cell, variant=None, device=CPU, seed=SEED):
    return harness.run_cell(cell, seed, 0.5, False, device, overrides=SMALL[cell],
                            variant=variant)


def numbers(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def broken(cell, monkeypatch, plant):
    sound = run(cell)
    plant(monkeypatch)
    bad = run(cell)
    monkeypatch.undo()
    assert not bad["correct"], numbers(bad)
    # the fault reads at least ten times what the sound run reads, in some number
    assert any(numbers(bad)[k] > 10 * max(numbers(sound)[k], 1e-9) for k in numbers(bad))
    return sound, bad


# -- faults ----------------------------------------------------------------------------

def test_preview_frame_altered(monkeypatch):
    from pathtrace_tpu_torch.models import infer

    def plant(mp):
        real = infer.denoise_with
        mp.setattr(infer, "denoise_with", lambda m, c: real(m, c) * 0.97)

    broken("cornell-diffuse.preview", monkeypatch, plant)


def test_preview_camera_left_unchanged(monkeypatch):
    from pathtrace_tpu_torch.interactive import FrameStepper

    def plant(mp):
        mp.setattr(FrameStepper, "move", lambda self, d, dt=1 / 60: None)

    broken("cornell-diffuse.preview", monkeypatch, plant)


def _collect_plant(mp, edit):
    from pathtrace_tpu_torch.data import collect

    real = collect.render_aovs

    def render(scene, cam, cfg, frame, device):
        return edit(real, scene, cam, cfg, frame, device)

    mp.setattr(collect, "render_aovs", render)


def test_collect_answer_altered(monkeypatch):
    def edit(real, scene, cam, cfg, frame, device):
        out = real(scene, cam, cfg, frame, device)
        return dict(out, color=out["color"] * 1.01)

    broken("cornell-diffuse.collect", monkeypatch, lambda mp: _collect_plant(mp, edit))


def test_collect_half_the_samples(monkeypatch):
    def edit(real, scene, cam, cfg, frame, device):
        return real(scene, cam, dataclasses.replace(cfg, spp=max(cfg.spp // 2, 1)), frame, device)

    broken("cornell-diffuse.collect", monkeypatch, lambda mp: _collect_plant(mp, edit))


def _inverse_plant(mp, wrap_step=None, wrap_grads=None):
    from pathtrace_tpu_torch import inverse

    if wrap_grads is not None:
        mp.setattr(inverse.grad_kernel, "cross_grads", wrap_grads(inverse.grad_kernel.cross_grads))
    if wrap_step is not None:
        real = inverse.make_inverse_step

        @functools.wraps(real)
        def make(*args, **kwargs):
            st, step_fn, opt = real(*args, **kwargs)
            return st, wrap_step(step_fn), opt

        mp.setattr(inverse, "make_inverse_step", make)


# sound_steps: the first steps of the process left sound, as set-up's warm-up
# takes 3; the steps the window times are the ones checked
@pytest.mark.parametrize("sound_steps", [0, 3])
def test_inverse_state_unchanged(monkeypatch, sound_steps):
    taken = [0]

    def wrap_step(step_fn):
        def step(state):
            taken[0] += 1
            if taken[0] <= sound_steps:
                return step_fn(state)
            new, loss = step_fn(state._replace(params={k: v.detach().clone().requires_grad_(True)
                                                       for k, v in state.params.items()}))
            return state._replace(step=new.step), loss
        return step

    broken("cornell-nee.inverse_geometry", monkeypatch,
           lambda mp: _inverse_plant(mp, wrap_step=wrap_step))


def test_inverse_half_the_samples(monkeypatch):
    def wrap_grads(real):
        def grads(scene, cam, cfg, step, target, device=None):
            return real(scene, cam, dataclasses.replace(cfg, spp=cfg.spp // 2), step, target,
                        device)
        return grads

    broken("cornell-nee.inverse_geometry", monkeypatch,
           lambda mp: _inverse_plant(mp, wrap_grads=wrap_grads))


def _train_plant(mp, wrap):
    from pathtrace_tpu_torch import train

    mp.setattr(train, "train_step", wrap(train.train_step))


@pytest.mark.parametrize("sound_steps", [0, 3])
def test_train_state_unchanged(monkeypatch, sound_steps):
    taken = [0]

    def wrap(real):
        def step(state, batch, target, dp=None):
            taken[0] += 1
            if taken[0] <= sound_steps:
                return real(state, batch, target, dp)
            saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            loss = real(state, batch, target, dp)
            state.model.load_state_dict(saved)
            return loss
        return step

    broken("cornell-diffuse.train", monkeypatch, lambda mp: _train_plant(mp, wrap))


def test_train_half_the_batch(monkeypatch):
    def wrap(real):
        def step(state, batch, target, dp=None):
            half = batch.shape[0] // 2
            return real(state, batch[:half], target[:half], dp)
        return step

    broken("cornell-diffuse.train", monkeypatch, lambda mp: _train_plant(mp, wrap))


# -- controls --------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["cornell-diffuse.collect", "cornell-nee.inverse_geometry"])
def test_bf16_control_fails(cell):
    assert not run(cell, "bf16")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cornell-diffuse.preview", "cornell-diffuse.train"])
def test_tf32_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card: the control runs there")
    overrides = dict(SMALL[cell])
    overrides.pop("widths")
    overrides.update(width=128, height=128) if "width" in overrides else overrides.update(patch=128)
    for seed in (11, 12, 13):
        r = harness.run_cell(cell, seed, 0.5, False, torch.device("cuda", 0),
                             overrides=overrides, variant="tf32")
        assert not r["correct"], numbers(r)
