"""Inverse rendering: recover scene parameters from a target image.

The counterpart of ``pathtrace_tpu.inverse``. Adam on the cross-estimator
``mean((A - T) * (B - T))`` between two independent renders A, B (frames
``2 step`` and ``2 step + 1``) and the target T: its expectation is
``||E[render] - T||^2`` with no variance term, whereas plain L2 on one noisy
render is biased toward darker scenes. Fresh frames every step make the
Monte Carlo noise independent across steps.

On ``"cuda"`` a step takes its loss and gradients from
``grad_kernel.cross_grads``, as the JAX package's all-Pallas step takes
them from ``pallas_cross_grads``. Diffuse without NEE: two dump-kernel
launches and the contraction; positions and radii get the exact zeros of
that estimator. NEE diffuse and glossy (with or without NEE): two
colour-sum launches of the forward kernel and two replay launches (the NEE
kernel, or the all-parameter backward for glossy), which also give the
position and radius gradients, so geometry is recovered on the kernels. The
albedo clip's subgradient is applied by hand (``clip01_grad``). On
``"torch"`` a step is autograd through the wavefront. Either way the albedo
is clipped to [0, 1] with ``clip01``, whose gradient at the boundary is
jnp.clip's 1/2.

``torch.optim.Adam`` takes the place of optax's ``adam``: the two updates
are the same function, ``lr * m_hat / (sqrt(v_hat) + eps)`` with b1 0.9,
b2 0.999, eps 1e-8, computed in another order. A dict of learning rates
gives one parameter group a field; a rate may be a schedule, a callable
``step -> lr`` evaluated at the number of steps taken so far, as optax
evaluates its schedules (``exponential_decay`` is optax's). The optimizer
updates the parameter tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Sequence

import torch

from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.grad import SCENE_FIELDS as FIELDS
from pathtrace_tpu_torch.grad import render_color
from pathtrace_tpu_torch.ops import grad_kernel
from pathtrace_tpu_torch.ops.sampling import clip01, clip01_grad
from pathtrace_tpu_torch.render import render_aovs, resolve_backend, resolve_device
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.utils.timing import span


class InverseState(NamedTuple):
    """params: {field: leaf tensor}; opt_state: the Adam optimizer that owns
    their moments; step: the number of steps taken."""

    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Adam
    step: int


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float):
    """optax's ``exponential_decay`` with its defaults: the schedule
    ``step -> init_value * decay_rate ** (step / transition_steps)``."""
    if transition_steps <= 0:
        raise ValueError(f"transition_steps must be positive, got {transition_steps}")

    def schedule(step: int) -> float:
        return init_value * decay_rate ** (step / transition_steps)

    return schedule


def apply_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    """``scene`` with the optimized fields put in; the albedo clipped to
    [0, 1] to stay physical."""
    fields = {name: params.get(name, getattr(scene, name)) for name in FIELDS}
    if "color" in params:
        fields["color"] = clip01(fields["color"])
    return Scene(*(fields[name] for name in FIELDS))


def make_inverse_step(base_scene: Scene, cam, cfg: RenderConfig, target: torch.Tensor,
                      optimize: Sequence[str] = ("color",), learning_rate=2e-2,
                      grad_mask: Dict[str, torch.Tensor] | None = None, device=None):
    """Returns (init_state, step_fn, optimizer).

    step_fn(state) -> (state', loss): one Adam step on the cross-estimator
    with respect to the fields in ``optimize``; ``loss`` is the estimate
    before the step. Its spans: ``inverse.step`` (the call), ``inverse.grads``
    and ``inverse.adam``. ``learning_rate`` is a float, a schedule (a callable
    ``step -> lr``), or a dict {field: float or schedule} for fields of
    different natural scales. ``grad_mask`` ({field: 0/1 tensor
    broadcastable to the field}) freezes entries: Adam normalizes step
    sizes, so even tiny gradients would walk every unmasked entry ~lr a
    step. Everything runs on ``device`` (default: the current CUDA device).
    """
    device = resolve_device(device)
    if isinstance(learning_rate, dict):
        missing = set(optimize) - set(learning_rate)
        if missing:
            raise ValueError(f"learning_rate missing fields: {missing}")
        rates = {name: learning_rate[name] for name in optimize}
    else:
        rates = {name: learning_rate for name in optimize}
    schedules = {name: r for name, r in rates.items() if callable(r)}
    rates = {name: float(r(0)) if callable(r) else float(r) for name, r in rates.items()}
    unknown = set(optimize) - set(FIELDS)
    if unknown:
        raise ValueError(f"cannot optimize {unknown}: fields are {FIELDS}")

    base = base_scene.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    params = {name: getattr(base, name).detach().clone().requires_grad_(True)
              for name in optimize}
    opt = torch.optim.Adam([{"params": [params[k]], "lr": rates[k]} for k in optimize],
                           betas=(0.9, 0.999), eps=1e-8)
    masks = {k: torch.as_tensor(m, dtype=torch.float32, device=device)
             for k, m in (grad_mask or {}).items()}
    use_kernel = resolve_backend(cfg, device) == "cuda"

    def kernel_loss_grads(params, step):
        with torch.no_grad():
            loss, d = grad_kernel.cross_grads(apply_params(base, params), cam, cfg, step,
                                              target, device)
        grads = {}
        for name, p in params.items():
            if name not in d:  # positions and radii, diffuse without NEE: exactly zero
                grads[name] = torch.zeros_like(p)
            elif name == "color":  # chained through apply_params' clip01
                grads[name] = d[name] * clip01_grad(p.detach())
            else:
                grads[name] = d[name]
        return loss, grads

    def autograd_loss_grads(params, step):
        scene = apply_params(base, params)
        a = render_color(scene, cam, cfg, 2 * step, device)
        b = render_color(scene, cam, cfg, 2 * step + 1, device)
        loss = torch.mean((a - target) * (b - target))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    loss_grads = kernel_loss_grads if use_kernel else autograd_loss_grads

    def step_fn(state: InverseState):
        with span("inverse.step"):
            with span("inverse.grads"):
                loss, grads = loss_grads(state.params, state.step)
            with span("inverse.adam"):
                for name, g in grads.items():
                    state.params[name].grad = g * masks[name] if name in masks else g
                for group, name in zip(state.opt_state.param_groups, optimize):
                    if name in schedules:
                        group["lr"] = float(schedules[name](state.step))
                state.opt_state.step()
        return InverseState(state.params, state.opt_state, state.step + 1), loss

    return InverseState(params, opt, 0), step_fn, opt


def recover_scene(true_scene: Scene, corrupted_scene: Scene, cam, cfg: RenderConfig,
                  optimize: Sequence[str] = ("color",), steps: int = 200,
                  learning_rate=2e-2, target_spp: int | None = None, log_every: int = 0,
                  logger: Callable | None = None,
                  grad_mask: Dict[str, torch.Tensor] | None = None, device=None):
    """Render a target from ``true_scene`` (frame 987654, ``target_spp``
    samples), then optimize ``corrupted_scene``'s fields in ``optimize`` to
    match it (``learning_rate`` and ``grad_mask`` as ``make_inverse_step``
    takes them). Returns (recovered_scene, losses)."""
    device = resolve_device(device)
    target_cfg = cfg if target_spp is None else dataclasses.replace(cfg, spp=target_spp)
    target = render_aovs(true_scene, cam, target_cfg, frame=987654, device=device)["color"]
    state, step_fn, _ = make_inverse_step(corrupted_scene, cam, cfg, target, optimize,
                                          learning_rate, grad_mask, device=device)
    losses = []
    for i in range(steps):
        state, loss = step_fn(state)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            (logger or print)(f"inverse step {i + 1}/{steps} loss {losses[-1]:.6f}")
    with torch.no_grad():
        recovered = apply_params(corrupted_scene.to(device), state.params)
    return Scene(*(getattr(recovered, k).detach() for k in FIELDS)), losses
