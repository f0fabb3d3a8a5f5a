"""The ("tiles", "samples") grid of ranks, and the multi-process runtime.

The counterpart of ``pathtrace_tpu.parallel.mesh`` on ``torch.distributed``.
The JAX package lays its devices out as a 2-D mesh:

  - axis "tiles":   image row slabs (pixel parallelism across devices);
  - axis "samples": spp ranges (sample parallelism across devices).

Here every rank is one process with one device, and the grid is a
``Mesh``: rank ``r`` sits at ``(ti, si) = divmod(r, samples)``, which is
``np.array(devices).reshape(tiles, samples)`` of the JAX mesh. Each axis
is a process group: "tiles" holds the ranks that share ``si``, "samples"
the ranks that share ``ti``, and ``group`` all ranks of the grid.

A rank runs on ``cuda:(LOCAL_RANK % device_count)`` (``torch.cuda.
set_device`` is called before any launch: the kernels launch on the
current stream of their device, so this is what puts each rank on its own
card), or on the CPU when asked for (``device="cpu"``). Several ranks may
share one card; then the world runs on gloo (``launch.choose_backend``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group (a no-op for one process) -> whether a group
    was joined.

    The arguments fall back to torchrun's environment: ``WORLD_SIZE`` (or
    ``PATHTRACE_NUM_PROCESSES``, as in the JAX package), ``RANK``,
    ``MASTER_ADDR:MASTER_PORT``. ``backend`` None is ``"nccl"`` where each
    rank has a card of its own, else ``"gloo"`` (``launch.choose_backend``).
    Fails loudly: a missing rank or address raises."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE",
                                           os.environ.get("PATHTRACE_NUM_PROCESSES", "1")))
    if num_processes <= 1 and coordinator_address is None:
        return False
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    if process_id is None:
        if "RANK" not in os.environ:
            raise RuntimeError(f"{num_processes} processes but no process_id and no RANK")
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise RuntimeError("no coordinator_address and no MASTER_ADDR/MASTER_PORT")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if backend is None:
        from pathtrace_tpu_torch.parallel.launch import choose_backend

        backend = choose_backend(num_processes, None)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)``, made the
    current CUDA device, for None; else ``torch.device(device)`` (a CUDA
    device is made current too). Without CUDA and without a device it
    raises, as ``render.resolve_device`` does."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available; pass device="cpu" to run on the CPU')
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ("tiles", "samples") grid.

    ``shape`` {"tiles": t, "samples": s}; ``rank`` this rank's index in the
    grid (``ti * samples + si``); ``ti``, ``si`` its coordinates;
    ``tiles_group`` and ``samples_group`` the process groups of its two
    axes, ``group`` the grid's (None: the rank is alone, no process group,
    and every collective is the identity); ``device`` its device."""

    shape: dict
    rank: int
    ti: int
    si: int
    tiles_group: object
    samples_group: object
    group: object
    device: torch.device

    @property
    def distributed(self) -> bool:
        return self.group is not None


def grid_shape(n: int, tiles: Optional[int] = None,
               samples: Optional[int] = None) -> tuple:
    """(tiles, samples) for ``n`` ranks with the JAX package's defaults: all
    ranks on "tiles"; raises where the shape does not factor ``n``."""
    if tiles is None and samples is None:
        tiles, samples = n, 1
    elif tiles is None:
        tiles = n // samples
    elif samples is None:
        samples = n // tiles
    if tiles * samples != n:
        raise ValueError(f"mesh {tiles}x{samples} != {n} devices; pick divisors of {n}")
    return tiles, samples


def make_mesh(tiles: Optional[int] = None, samples: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None, device=None) -> Optional[Mesh]:
    """A ("tiles", "samples") grid over ``ranks`` (default: every rank of the
    world; one rank alone when no process group is initialised).

    Every rank of the world must call it with the same arguments, since
    process groups are made collectively; a rank outside ``ranks`` gets
    None. The grid takes ``ranks`` in increasing order (a group's ranks are
    in that order in torch). ``device``: see ``rank_device``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else sorted(int(r) for r in ranks)
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
    tiles, samples = grid_shape(len(ranks), tiles, samples)
    me = dist.get_rank() if dist.is_initialized() else 0
    shape = {"tiles": tiles, "samples": samples}
    if not dist.is_initialized():
        return Mesh(shape, 0, 0, 0, None, None, None, rank_device(device))

    def new_group(members):
        return None if members == list(range(world)) else dist.new_group(members)

    tiles_groups = [new_group([ranks[t * samples + s] for t in range(tiles)])
                    for s in range(samples)]
    samples_groups = [new_group([ranks[t * samples + s] for s in range(samples)])
                      for t in range(tiles)]
    group = new_group(ranks)
    if me not in ranks:
        return None
    ti, si = divmod(ranks.index(me), samples)
    world_group = dist.group.WORLD
    return Mesh(shape, ranks.index(me), ti, si, tiles_groups[si] or world_group,
                samples_groups[ti] or world_group, group or world_group, rank_device(device))
