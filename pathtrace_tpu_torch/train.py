"""Denoise-CNN trainer and its checkpoints.

The counterpart of ``pathtrace_tpu.train`` (the reference's training loop,
``denoise_cnn/train.py:78-120``):

- loss: mean L1 (``train.py:95``);
- optimizer: SGD lr=0.01, momentum 0.9, nesterov (``train.py:97``):
  ``torch.optim.SGD`` with dampening 0 is optax's rule (buffer = 0.9 *
  buffer + g, update = g + 0.9 * buffer; torch's first buffer = g is optax's
  zero trace after one step). ``TrainState.lr`` is written into the
  optimiser before each step, as the JAX package injects it;
- LR schedule: reduce-on-plateau x0.5, patience 5000, threshold 1e-4
  (``train.py:98``) as explicit trainer state (``plateau_update``), in f32
  as the JAX package computes it. It is not
  ``torch.optim.lr_scheduler.ReduceLROnPlateau``, which moves its best loss
  only on an improvement beyond the threshold; here the best loss follows
  every epoch's loss down;
- batch size 5 (``train.py:87``); default epoch budget 400,000
  (``train.py:109``); each epoch shuffles with
  ``np.random.default_rng(seed)`` and drops the remainder;
- every ``ckpt_every`` epochs: a checkpoint, validation (PSNR computed from
  the L1 criterion — the reference's quirk, ``train.py:40-43``), preview
  BMPs, and ``model_best`` + ``best.json`` when the PSNR is the best yet.

Training runs in f32 with cuDNN's TF32 off (``cudnn_tf32(False)``) and its
deterministic algorithms on (``cudnn_deterministic``), on the
current CUDA device unless ``device="cpu"`` is given. Two routes run an
epoch: ``loop_epoch`` (the host gathers each minibatch and reads each loss)
and ``train_epoch`` (``--scan-epochs``: the dataset on the device, moved
there once a run, minibatches gathered by index there, one read of the
mean loss an epoch), with the same order and the same updates.

A checkpoint directory holds the JAX package's ``model.json`` (``widths``,
``lateral_features``) and ``<name>.pt`` (``name`` "model_epoch", the
latest, or "model_best"): a ``torch.save`` of ``{"model": state dict}``
and, when written from a ``TrainState``, its momentum buffers by parameter
name, ``lr``, ``best_loss``, ``plateau_count`` and ``epoch``
(``TrainState.state_dict``). The JAX package's orbax snapshots are not read
here: ``scripts/torch_convert_checkpoint.py`` converts one on a machine with
JAX.

Batch data parallelism (``dp_sharding``, as the JAX package's) splits each
minibatch over the ranks of a ``torch.distributed`` world: rank r of n
takes rows [r b/n, (r+1) b/n), the block JAX's ``P("batch")`` gives device
r. It is the single-device function, not an approximation of it: the L1
mean and BatchNorm's statistics are taken over the whole batch
(``models.denoise_cnn.batch_stats`` all-reduces them, their gradient
included), and the weight gradients are summed over the ranks in one
all-reduce before SGD, so every rank holds the same weights, momentum
buffers and statistics, bit for bit. In ``fit`` every rank shuffles with
the same seed and rank 0 alone writes files; outside a world, on a machine
with several cards, ``fit`` starts a world of one rank a card
(``parallel.launch``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pathtrace_tpu_torch.models.denoise_cnn import (DenoiseCNN, cudnn_deterministic, cudnn_tf32,
                                                    init_model)
from pathtrace_tpu_torch.models.preprocess import preprocess_channels, preprocess_target
from pathtrace_tpu_torch.render import resolve_device

BATCH_SIZE = 5
BASE_LR = 0.01
MOMENTUM = 0.9
PLATEAU_FACTOR = 0.5
PLATEAU_PATIENCE = 5000
PLATEAU_THRESHOLD = 1e-4
# The validation pair: the reference's default camera, a frame no training
# pose uses.
DEFAULT_POSE = (50.0, 52.0, 295.6, -90.0, 0.0)
VALIDATION_FRAME = 10_000


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass
class TrainState:
    """The trainer's state: the model (in training mode on its device), its
    SGD optimiser (which holds the momentum buffers) and the plateau
    schedule's fields, f32 values held as Python numbers."""

    model: DenoiseCNN
    optimizer: torch.optim.SGD
    lr: float = _f32(BASE_LR)
    best_loss: float = math.inf
    plateau_count: int = 0
    epoch: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def momentum(self) -> Dict[str, torch.Tensor]:
        """Parameter name -> momentum buffer; zeros where no step has made one
        yet (optax's fresh trace, which the first step treats alike)."""
        out = {}
        for name, p in self.model.named_parameters():
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            out[name] = torch.zeros_like(p) if buf is None else buf
        return out

    def state_dict(self) -> dict:
        """Everything a resumed run needs, on the host (see the module
        docstring for the layout)."""
        return {
            "model": {k: v.detach().to("cpu") for k, v in self.model.state_dict().items()},
            "momentum": {k: v.detach().to("cpu") for k, v in self.momentum().items()},
            "lr": self.lr,
            "best_loss": self.best_loss,
            "plateau_count": self.plateau_count,
            "epoch": self.epoch,
        }

    def load_state_dict(self, payload: dict) -> None:
        """Restore ``state_dict``'s layout (from a checkpoint or
        ``convert.train_state_from_flax``) into this state's model and
        optimiser, on their device and in their memory format."""
        self.model.load_state_dict(payload["model"])
        params = dict(self.model.named_parameters())
        momentum = payload["momentum"]
        if set(momentum) != set(params):
            raise ValueError(f"momentum buffers for {sorted(set(momentum) ^ set(params))} "
                             "do not match the model's parameters")
        for name, p in params.items():
            self.optimizer.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(momentum[name])
        self.lr = _f32(payload["lr"])
        self.best_loss = _f32(payload["best_loss"])
        self.plateau_count = int(payload["plateau_count"])
        self.epoch = int(payload["epoch"])


def make_optimizer(model: torch.nn.Module) -> torch.optim.SGD:
    """SGD with Nesterov momentum 0.9, optax's ``sgd(0.01, momentum=0.9,
    nesterov=True)``."""
    return torch.optim.SGD(model.parameters(), lr=_f32(BASE_LR), momentum=MOMENTUM,
                           dampening=0.0, weight_decay=0.0, nesterov=True)


def create_state(model: DenoiseCNN, device=None) -> TrainState:
    """A fresh ``TrainState`` for ``model``, which moves to ``device``
    (default: the current CUDA device) with channels-last weights, the
    layout of the NHWC batches."""
    device = resolve_device(device)
    model = model.to(device, memory_format=torch.channels_last).train()
    return TrainState(model=model, optimizer=make_optimizer(model))


def state_payload(state: TrainState) -> dict:
    """What a new process needs to rebuild ``state`` (``state_from_payload``):
    the model's widths and ``TrainState.state_dict``, on the host."""
    return {"widths": state.model.widths, "lateral_features": state.model.lateral_features,
            "state": state.state_dict()}


def state_from_payload(payload: dict, device=None) -> "TrainState":
    """The ``TrainState`` of ``state_payload``'s dict on ``device`` (default:
    the current CUDA device)."""
    model = DenoiseCNN(payload["widths"], payload["lateral_features"])
    state = create_state(model, device)
    state.load_state_dict(payload["state"])
    return state


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A batch split over the ``size`` ranks of the process group ``group``;
    this rank is ``index`` of them and takes the ``index``-th block of rows
    of every minibatch."""

    group: object
    index: int
    size: int

    def rows(self, batch_size: int) -> slice:
        if batch_size % self.size:
            raise ValueError(f"a batch of {batch_size} does not split over {self.size} ranks")
        share = batch_size // self.size
        return slice(self.index * share, (self.index + 1) * share)


def dp_devices(batch_size: int, n_devices: int) -> int:
    """How many of ``n_devices`` a batch splits over: the most that divide
    ``batch_size`` (the JAX package's rule: a batch of 5 uses 5 of 8)."""
    return max(d for d in range(1, n_devices + 1) if batch_size % d == 0)


def dp_sharding(batch_size: int, devices=None) -> Optional[DataParallel]:
    """The batch split of the JAX package's ``dp_sharding`` over the ranks of
    the world: ``devices`` are ranks (default: every rank of the world, or
    this process alone outside a world), of which the first
    ``dp_devices(batch_size, len(devices))`` train. -> their split as this
    rank sees it, or None where that count is 1 (one device) or this rank
    is not among them (it holds no training state). Every rank of the
    world calls it with the same arguments (process groups are made
    collectively)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"devices {ranks} are not distinct ranks of a world of {world}")
    n = dp_devices(batch_size, len(ranks))
    if n == 1:
        return None
    members = sorted(ranks[:n])
    group = dist.group.WORLD if members == list(range(world)) else dist.new_group(members)
    me = dist.get_rank()
    if me not in members:
        return None
    return DataParallel(group, members.index(me), n)


def _all_reduce_grads(model: torch.nn.Module, loss: torch.Tensor, group) -> torch.Tensor:
    """Sum every parameter's gradient and ``loss`` over ``group`` in one
    all-reduce of a flat buffer; the gradients are written back in place.
    -> the summed loss."""
    grads = [p.grad for p in model.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view(g.shape))
        offset += g.numel()
    return flat[offset]


def train_step(state: TrainState, batch: torch.Tensor, target: torch.Tensor,
               dp: Optional[DataParallel] = None) -> torch.Tensor:
    """One SGD step on an [N, h, w, 14] batch vs [N, h, w, 3] targets (moved
    to the state's device), in place. With ``dp`` this rank takes its rows
    of the batch, BatchNorm's statistics and the L1 mean are the whole
    batch's, and the gradients are summed over the ranks before the step.
    -> the whole batch's loss, a 0-d tensor on the device (reading it waits
    for the step), the same on every rank."""
    device = state.device
    if dp is not None:
        rows = dp.rows(batch.shape[0])
        batch, target = batch[rows], target[rows]
    batch, target = batch.to(device), target.to(device)
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr
    state.model.train()
    with cudnn_tf32(False), cudnn_deterministic():
        state.optimizer.zero_grad(set_to_none=True)
        pred = state.model(batch, None if dp is None else dp.group)
        # This rank's share of the whole batch's mean: the shares sum to it.
        loss = l1_loss(pred, target) / (1 if dp is None else dp.size)
        loss.backward()
        loss = loss.detach()
        if dp is not None:
            loss = _all_reduce_grads(state.model, loss, dp.group)
        state.optimizer.step()
    return loss


def loop_epoch(state: TrainState, inputs: np.ndarray, targets: np.ndarray,
               order: np.ndarray, batch_size: int, dp: Optional[DataParallel] = None) -> float:
    """One epoch the way the JAX package's ``fit`` loops: each minibatch
    gathered on the host in ``order`` and moved to the device (with ``dp``,
    this rank's rows of it), each loss read back; the remainder is dropped.
    -> the mean loss."""
    epoch_loss, batches = 0.0, 0
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[i: i + batch_size]
        loss = train_step(state, torch.from_numpy(inputs[idx]), torch.from_numpy(targets[idx]),
                          dp)
        epoch_loss += float(loss)
        batches += 1
    return epoch_loss / max(batches, 1)


def train_epoch(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor, perm,
                batch_size: int, dp: Optional[DataParallel] = None) -> torch.Tensor:
    """One full epoch over a dataset that stays where it is (on the device,
    for ``fit(scan_epochs=True)``): the minibatches of ``perm`` (the epoch's
    shuffled indices, remainder dropped) gathered by index there, the
    losses kept there; with ``dp`` each step takes this rank's rows. Same
    order and updates as ``loop_epoch`` (the JAX package's ``lax.scan``
    epoch). -> the mean loss, a 0-d tensor."""
    n_batches = len(perm) // batch_size
    idx = torch.as_tensor(np.asarray(perm)[: n_batches * batch_size], device=inputs.device)
    losses = [train_step(state, inputs.index_select(0, ids), targets.index_select(0, ids), dp)
              for ids in idx.view(n_batches, batch_size)]
    return torch.stack(losses).mean()


def plateau_update(state: TrainState, epoch_loss, patience: int = PLATEAU_PATIENCE) -> TrainState:
    """ReduceLROnPlateau('min', factor=0.5, patience=5000, threshold=1e-4)
    in relative mode as the JAX package writes it, in f32, in place: an
    epoch improves iff loss < best * (1 - threshold); after more than
    ``patience`` epochs without one the rate halves and the count restarts;
    the best loss is min(best, loss) on every epoch. ``patience`` defaults
    to the reference's 5000 (tuned for its 400k-epoch budget,
    denoise_cnn/train.py:98,109); scale it with the epoch budget so the
    schedule acts (--plateau-patience)."""
    loss = np.float32(epoch_loss)
    best = np.float32(state.best_loss)
    improved = loss < best * np.float32(1.0 - PLATEAU_THRESHOLD)
    count = 0 if improved else state.plateau_count + 1
    if count > patience:
        state.lr = _f32(np.float32(state.lr) * np.float32(PLATEAU_FACTOR))
        count = 0
    state.best_loss = float(np.minimum(best, loss))
    state.plateau_count = count
    state.epoch += 1
    return state


def eval_step(state: TrainState, batch: torch.Tensor, target: torch.Tensor):
    """The model in eval mode (running BN statistics) on a batch on the
    state's device -> (out, loss, psnr), psnr = 10 log10(1 / L1) (the
    reference's quirk, train.py:43)."""
    device = state.device
    state.model.eval()
    with torch.no_grad(), cudnn_tf32(False):
        out = state.model(batch.to(device))
        loss = l1_loss(out, target.to(device))
    psnr = 10.0 * torch.log10(1.0 / torch.clamp(loss, min=1e-12))
    return out, loss, psnr


# -- checkpoints --------------------------------------------------------------

def checkpoint_file(ckpt_dir: str, name: str = "model_epoch") -> str:
    return os.path.join(ckpt_dir, f"{name}.pt")


def save_checkpoint(ckpt_dir: str, state, name: str = "model_epoch") -> str:
    """Write ``model.json`` and ``<name>.pt`` into ``ckpt_dir`` -> the .pt
    path. ``state`` is a ``TrainState`` (the model, momentum buffers and
    plateau fields) or a bare ``DenoiseCNN`` (the model alone, enough for
    ``load_checkpoint``). Written from the host, so it loads on any device;
    the file is replaced atomically."""
    model = state.model if isinstance(state, TrainState) else state
    payload = state.state_dict() if isinstance(state, TrainState) else {
        "model": {k: v.detach().to("cpu") for k, v in model.state_dict().items()}}
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "model.json"), "w") as f:
        json.dump({"widths": list(model.widths), "lateral_features": model.lateral_features}, f)
    path = checkpoint_file(ckpt_dir, name)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(ckpt_dir: str, name: str) -> Tuple[DenoiseCNN, dict]:
    """(the model of ``model.json``, on the CPU; the payload of
    ``<name>.pt``). The default widths where there is no ``model.json``, as
    in the JAX package; a missing .pt raises ``FileNotFoundError``."""
    payload = torch.load(checkpoint_file(ckpt_dir, name), map_location="cpu", weights_only=True)
    spec_path = os.path.join(ckpt_dir, "model.json")
    if os.path.exists(spec_path):
        with open(spec_path) as f:
            spec = json.load(f)
        model = DenoiseCNN(widths=spec["widths"], lateral_features=spec["lateral_features"])
    else:
        model = DenoiseCNN()
    return model, payload


def load_checkpoint(ckpt_dir: str, name: str = "model_epoch") -> DenoiseCNN:
    """The ``DenoiseCNN`` of a checkpoint directory with the weights of
    ``<name>.pt``, on the CPU, in eval mode (what inference wants)."""
    model, payload = _read(ckpt_dir, name)
    model.load_state_dict(payload["model"])
    return model.eval()


def load_train_state(ckpt_dir: str, name: str = "model_epoch", device=None) -> TrainState:
    """The ``TrainState`` of ``<name>.pt`` on ``device`` (default: the
    current CUDA device): weights, momentum buffers and plateau fields, as
    ``--resume`` wants them. A checkpoint of a bare model raises
    ``ValueError``."""
    device = resolve_device(device)
    model, payload = _read(ckpt_dir, name)
    if "momentum" not in payload:
        raise ValueError(f"{checkpoint_file(ckpt_dir, name)} holds a model without the "
                         "trainer's state (momentum, plateau): it cannot be resumed")
    state = create_state(model, device)
    state.load_state_dict(payload)
    return state


# -- dataset assembly (data.py:5-30 equivalent, in-process) --------------------

def interior_pose(rng) -> tuple:
    """A camera pose that looks INTO the Cornell box: position jittered
    around the reference default (50, 52, 295.6), yaw around -90, modest
    pitch (the JAX package's sampler, drawing in the same order). The
    reference's checked-in training data came from a curated pose list
    (collect_data.py --list); its unused ``get_random_position`` ranges span
    mostly wall-facing views, so this sampler is the curated-list analog for
    self-contained dataset builds."""
    return (
        float(rng.uniform(15.0, 85.0)),
        float(rng.uniform(25.0, 80.0)),
        float(rng.uniform(120.0, 295.0)),
        float(rng.uniform(-125.0, -55.0)),
        float(rng.uniform(-15.0, 15.0)),
    )


def build_dataset(
    scene,
    cfg,
    n_poses: int = 4,
    patch_size: int = 64,
    patches_per_image: int = 8,
    spp_train: int = 2,
    spp_gt: int = 64,
    seed: int = 0,
    save_dir=None,
    poses=None,
    pose_mode: str = "reference",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render pose pairs on ``device`` (default: the current CUDA device) and
    cut importance-sampled patches on the host.

    Returns (inputs [N, p, p, 14] preprocessed, targets [N, p, p, 3]), numpy.
    The reference uses 33 poses x 16 patches of 256^2 (data.py:9-11); the
    defaults here are scaled down, the CLI's are the reference's counts at
    64^2. ``poses`` overrides the sampler (the --list analog); otherwise
    ``pose_mode`` picks "reference" (collect_data.py:8-14 ranges) or
    "interior" (box-facing views — see interior_pose). One generator seeded
    with ``seed`` draws the poses, then every image's patches, in the JAX
    package's order.
    """
    from pathtrace_tpu_torch.data.collect import collect_dataset, random_pose
    from pathtrace_tpu_torch.data.patches import get_patches

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if poses is None:
        sampler = interior_pose if pose_mode == "interior" else random_pose
        poses = [sampler(rng) for _ in range(n_poses)]
    noisies, gts = collect_dataset(scene, poses, cfg, spp_train=spp_train, spp_gt=spp_gt,
                                   save_dir=save_dir, device=device)
    xs, ys = [], []
    for noisy, gt in zip(noisies, gts):
        x = preprocess_channels(torch.from_numpy(noisy)).numpy()
        y = preprocess_target(torch.from_numpy(gt)).numpy()
        px, py = get_patches(x, y, patch_size, patches_per_image, rng=rng)
        xs.append(px)
        ys.append(py)
    return np.concatenate(xs), np.concatenate(ys)


def fit(
    state: TrainState,
    inputs: np.ndarray,
    targets: np.ndarray,
    epochs: int,
    batch_size: int = BATCH_SIZE,
    seed: int = 0,
    log_every: int = 10,
    ckpt_dir=None,
    ckpt_every: int = 50,
    val=None,
    logger=print,
    data_parallel: bool = True,
    metrics=None,
    scan_epochs: bool = False,
    plateau_patience: int = PLATEAU_PATIENCE,
) -> Tuple[TrainState, List[float]]:
    """Epoch loop on the state's device: shuffle, minibatch SGD, plateau LR;
    every ``ckpt_every`` epochs checkpoint + (if ``val=(vx, vy)`` given)
    validate with PSNR and dump ``{epoch}_gt`` / ``{epoch}_out`` preview
    BMPs — the reference's 50-epoch cadence (train.py:110-119).
    ``scan_epochs=True`` runs each epoch through ``train_epoch`` with the
    dataset on the device; otherwise ``loop_epoch``. ``metrics`` is an
    optional ``JsonlLogger`` receiving one record an epoch and one a
    validation. Returns (state, history), the state updated in place.

    ``data_parallel`` is the JAX package's batch split (``dp_sharding``):

    - inside a world (every rank calls ``fit`` alike), each minibatch splits
      over the first ``dp_devices(batch_size, world size)`` ranks; a rank
      beyond them takes no step and returns (None, []). Every rank that
      trains shuffles with ``seed`` and returns the same state and history,
      after rank 0 alone has logged, validated and written the checkpoints,
      ``best.json``, the previews and the metrics;
    - outside a world, where the state's device is one of several cards
      that the batch splits over, ``fit`` starts a world of one rank a card
      (``parallel.launch``, NCCL), runs there and loads rank 0's state
      into ``state``; ``logger`` is then called in rank 0's process (it
      must pickle, as ``print`` does) and ``metrics`` is reopened there by
      its path;
    - on one device (one H100) it changes nothing.

    With ``data_parallel=False`` in a world every rank trains on the whole
    batches alone, and rank 0 alone writes.
    """
    from pathtrace_tpu_torch.io.bmp import write_bmp
    from pathtrace_tpu_torch.utils.metrics import JsonlLogger

    device = state.device
    dp = None
    if data_parallel and dist.is_initialized():
        n_split = dp_devices(batch_size, dist.get_world_size())
        dp = dp_sharding(batch_size)
        if dist.get_rank() >= n_split:
            return None, []
    elif data_parallel and device.type == "cuda":
        n_split = dp_devices(batch_size, torch.cuda.device_count())
        if n_split > 1:
            return _fit_launched(n_split, state, inputs, targets, epochs, metrics,
                                 dict(batch_size=batch_size, seed=seed, log_every=log_every,
                                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, val=val,
                                      logger=logger, scan_epochs=scan_epochs,
                                      plateau_patience=plateau_patience))
    writer = not dist.is_initialized() or dist.get_rank() == 0
    metrics = metrics if metrics is not None and writer else JsonlLogger(None)
    rng = np.random.default_rng(seed)
    n = inputs.shape[0]
    if scan_epochs:
        inputs_d = torch.from_numpy(np.ascontiguousarray(inputs)).to(device)
        targets_d = torch.from_numpy(np.ascontiguousarray(targets)).to(device)
    history = []
    best_psnr = -float("inf")
    if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "best.json")):
        with open(os.path.join(ckpt_dir, "best.json")) as f:
            best_psnr = float(json.load(f)["psnr_db"])  # resume keeps the bar
    for _ in range(epochs):
        t0 = time.perf_counter()
        order = rng.permutation(n)
        if scan_epochs:
            avg = float(train_epoch(state, inputs_d, targets_d, order, batch_size, dp))
        else:
            avg = loop_epoch(state, inputs, targets, order, batch_size, dp)
        plateau_update(state, avg, patience=plateau_patience)
        history.append(avg)
        epoch = state.epoch
        if not writer:
            continue
        epoch_s = time.perf_counter() - t0
        metrics.log("epoch", epoch=epoch, loss=avg, lr=state.lr, seconds=epoch_s)
        if log_every and epoch % log_every == 0:
            logger(f"===> Epoch {epoch} Complete: Avg. Loss: {avg:.7f}")
        if ckpt_dir and epoch % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state)
            if val is not None:
                vx, vy = val
                out, vloss, psnr = eval_step(state, torch.from_numpy(vx), torch.from_numpy(vy))
                vloss, psnr = float(vloss), float(psnr)
                logger(f"===> Avg. Loss: {vloss:.7f}, Avg. PSNR: {psnr:.4f} dB")
                metrics.log("validate", epoch=epoch, val_loss=vloss, psnr_db=psnr)
                if psnr > best_psnr:
                    best_psnr = psnr
                    save_checkpoint(ckpt_dir, state, name="model_best")
                    with open(os.path.join(ckpt_dir, "best.json"), "w") as f:
                        json.dump({"epoch": epoch, "psnr_db": best_psnr}, f)
                    logger(f"===> New best validation PSNR {best_psnr:.4f} dB "
                           f"(epoch {epoch}) -> model_best")
                write_bmp(os.path.join(ckpt_dir, f"{epoch}_gt.bmp"),
                          np.clip(np.asarray(vy[0]), 0, 1))
                write_bmp(os.path.join(ckpt_dir, f"{epoch}_out.bmp"),
                          np.clip(out[0].cpu().numpy(), 0, 1))
    if dp is not None:
        dist.barrier(group=dp.group)  # every rank returns once rank 0's files are written
    return state, history


def _fit_rank(payload: dict, inputs, targets, epochs: int, metrics_path, kwargs: dict,
              device=None) -> dict:
    """A rank of ``_fit_launched``'s world: the state of ``payload``
    (``state_payload``) on this rank's device, ``fit`` with the batch split.
    -> {"history"}, and rank 0's "state" (``TrainState.state_dict``)."""
    from pathtrace_tpu_torch.parallel.mesh import rank_device
    from pathtrace_tpu_torch.utils.metrics import JsonlLogger

    state = state_from_payload(payload, rank_device(device))
    with JsonlLogger(metrics_path if dist.get_rank() == 0 else None) as metrics:
        state, history = fit(state, inputs, targets, epochs, metrics=metrics,
                             data_parallel=True, **kwargs)
    out = {"history": history}
    if dist.get_rank() == 0:
        out["state"] = state.state_dict()
    return out


def _fit_launched(n: int, state: TrainState, inputs, targets, epochs: int, metrics,
                  kwargs: dict, device=None) -> Tuple[TrainState, List[float]]:
    """``fit`` on a new local world of ``n`` ranks (``device`` None: one card
    a rank; ``"cpu"``), from ``state``, which then takes rank 0's state.
    Raises where a rank failed or the ranks' histories differ."""
    from pathtrace_tpu_torch.parallel.launch import launch

    out = launch(_fit_rank, n, state_payload(state), inputs, targets, epochs,
                 getattr(metrics, "path", None), kwargs, device=device, timeout_s=None)
    if any(r["history"] != out[0]["history"] for r in out):
        raise RuntimeError("the ranks of the data-parallel world returned different histories")
    state.load_state_dict(out[0]["state"])
    return state, out[0]["history"]


def dryrun_cnn_dp(mesh) -> float:
    """One batch-data-parallel training step over every rank of ``mesh`` (a
    ``parallel.Mesh``; the JAX package's ``dryrun_cnn_dp``): the CNN at
    widths (8, 16) from ``init_model`` seed 0, a batch of 2 zero patches of
    16x16 a rank. -> the step's loss; raises where it is not finite."""
    n = mesh.shape["tiles"] * mesh.shape["samples"]
    state = create_state(init_model(torch.Generator().manual_seed(0), widths=(8, 16)),
                         mesh.device)
    dp = DataParallel(mesh.group, mesh.rank, n) if mesh.distributed else None
    loss = train_step(state, torch.zeros((2 * n, 16, 16, 14)), torch.zeros((2 * n, 16, 16, 3)),
                      dp)
    if not torch.isfinite(loss):
        raise RuntimeError(f"the data-parallel step's loss {float(loss)} is not finite")
    return float(loss)


def build_parser() -> argparse.ArgumentParser:
    """The training CLI's flags: the JAX trainer's, and ``--device``."""
    from pathtrace_tpu_torch.cli import device_arg

    p = argparse.ArgumentParser(description="Train denoising algorithm")
    p.add_argument("--name", type=str, help="Name for output directory")
    p.add_argument("--resume", type=str, help="Name of output directory")
    p.add_argument(
        "--resume-epoch",
        type=int,
        help="Epoch # to start at; overrides the checkpoint's own counter "
        "(reference denoise_cnn/train.py:82,91)",
    )
    p.add_argument("--epochs", type=int, default=400000)
    p.add_argument("--size", type=int, default=256, help="Render size for data collection")
    p.add_argument("--poses", type=int, default=33)
    p.add_argument("--patch-size", type=int, default=64)
    p.add_argument("--patches-per-image", type=int, default=16)
    p.add_argument("--spp-train", type=int, default=2)
    p.add_argument("--spp-gt", type=int, default=512)
    p.add_argument("--batch", type=int, default=BATCH_SIZE)
    p.add_argument("--data-dir", type=str, help="Also export EXR pairs here")
    p.add_argument("--scan-epochs", action="store_true",
                   help="Keep the dataset on the device and gather each minibatch there "
                        "(train_epoch): same math, one read of the loss an epoch")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--plateau-patience", type=int, default=PLATEAU_PATIENCE,
                   help="ReduceLROnPlateau patience in epochs (reference "
                        "default 5000 assumes a 400k-epoch budget; scale it "
                        "down for shorter runs so the schedule can act)")
    p.add_argument("--pose-mode", choices=["reference", "interior"],
                   default="reference",
                   help="Pose sampler: the reference's get_random_position "
                        "ranges, or box-facing interior views")
    p.add_argument("--pose-list", type=str,
                   help="Camera-pose list file (collect_data.py --list)")
    p.add_argument("--widths", type=str, default=None,
                   help="Comma-separated encoder widths (capacity probe; "
                        "reference: 32,64,128,256,512,1024 model.py:49-56)")
    p.add_argument("--lateral-features", type=int, default=None,
                   help="FPN lateral width (reference: 32, model.py:60)")
    p.add_argument("--device", type=device_arg, default=0,
                   help="CUDA device index to train on, or 'cpu'")
    return p


def main(argv=None) -> int:
    from pathtrace_tpu_torch.cli import resolve_device_arg

    args = build_parser().parse_args(argv)
    device, err = resolve_device_arg(args.device)
    if err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1

    from pathtrace_tpu_torch import RenderConfig, cornell_box
    from pathtrace_tpu_torch.data.collect import load_poses, render_pair
    from pathtrace_tpu_torch.utils.metrics import JsonlLogger

    scene = cornell_box()
    cfg = RenderConfig(width=args.size, height=args.size, spp=2, backend="auto")

    print(f"===> Rendering datasets (in-process, on {device})")
    pose_rows = None
    if args.pose_list:
        pose_rows = [tuple(map(float, r)) for r in load_poses(args.pose_list)]
    inputs, targets = build_dataset(
        scene,
        cfg,
        n_poses=args.poses,
        patch_size=args.patch_size,
        patches_per_image=args.patches_per_image,
        spp_train=args.spp_train,
        spp_gt=args.spp_gt,
        save_dir=args.data_dir,
        poses=pose_rows,
        pose_mode=args.pose_mode,
        device=device,
    )
    print(f"===> Dataset: {inputs.shape} -> {targets.shape}")

    # Validation set: one full-frame pair at the default camera pose (the
    # reference's test set is pair 0 full-frame, data.py:27-29), validated
    # on the checkpoint cadence with PSNR + preview dumps.
    vnoisy, vgt = render_pair(scene, DEFAULT_POSE, cfg, spp_train=args.spp_train,
                              spp_gt=args.spp_gt, frame=VALIDATION_FRAME, device=device)
    vx = preprocess_channels(torch.from_numpy(vnoisy)).numpy()[None]
    vy = preprocess_target(torch.from_numpy(vgt)).numpy()[None]

    print("===> Building model")
    if args.resume:
        base_dir = args.resume
        state = load_train_state(base_dir, device=device)
        print(f"===> Resumed at epoch {state.epoch}")
        if args.resume_epoch is not None and args.resume_epoch != state.epoch:
            print(f"===> --resume-epoch {args.resume_epoch} overrides the "
                  f"checkpoint's epoch counter ({state.epoch})")
            state.epoch = args.resume_epoch
    else:
        base_dir = os.path.join("results", str(int(time.time()))[2:])
        if args.name:
            base_dir += "_" + args.name
        kwargs = {}
        if args.widths:
            kwargs["widths"] = tuple(int(w) for w in args.widths.split(","))
        if args.lateral_features:
            kwargs["lateral_features"] = args.lateral_features
        state = create_state(init_model(torch.Generator().manual_seed(0), **kwargs), device)
    os.makedirs(base_dir, exist_ok=True)
    print(f"===> Output directory: {base_dir}")

    with JsonlLogger(os.path.join(base_dir, "metrics.jsonl")) as metrics:
        state, _ = fit(
            state,
            inputs,
            targets,
            epochs=args.epochs,
            batch_size=args.batch,
            ckpt_dir=base_dir,
            ckpt_every=args.ckpt_every,
            log_every=1,
            val=(vx, vy),
            metrics=metrics,
            scan_epochs=args.scan_epochs,
            plateau_patience=args.plateau_patience,
        )
    save_checkpoint(base_dir, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
