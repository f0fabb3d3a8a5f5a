"""Strong-scaling measurement of the sharded render.

The counterpart of ``pathtrace_tpu.parallel.scaling``. ``measure_scaling``
times ``render_channels_sharded`` on grids of the first 1, 2, 4, ... ranks
of a launched world and reports efficiency = T(1) / (N T(N)) where each
rank of the grid has a device of its own. Ranks that share one device
(several ranks on one card, or on the CPU) check the harness, not the
hardware: their rows carry no efficiency.

    python -m pathtrace_tpu_torch.parallel.scaling --json

runs a world of one rank a card (``torch.cuda.device_count()``, NCCL) and
prints one JSON line: the table by grid, the backend, the host, rank and
device counts, and the 80% gate, which is null with its reason on one
device. ``--device cpu --ranks N`` runs the same harness on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.parallel.launch import choose_backend, launch
from pathtrace_tpu_torch.parallel.mesh import make_mesh
from pathtrace_tpu_torch.parallel.shard import render_channels_sharded
from pathtrace_tpu_torch.utils.timing import mrays_per_sec, time_fn

SHARED_DEVICE_NOTE = "ranks share one device: not a scaling figure"


def time_call(fn, device: torch.device, iters: int) -> float:
    """Median seconds of ``iters`` calls of ``fn`` after one warm-up: CUDA
    events on a card, the host's clock (the work done when ``fn`` returns)
    on the CPU."""
    if device.type == "cuda":
        ms, _ = time_fn(fn, warmup=1, iters=iters, device=device)
        return statistics.median(ms) / 1e3
    fn()
    secs = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def distinct_devices(n: int, device: torch.device) -> int:
    """The devices ``n`` ranks of a world run on (``mesh.rank_device``)."""
    if device.type != "cuda":
        return 1
    return min(n, torch.cuda.device_count())


def _barrier(device: torch.device):
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()


def measure_scaling(scene, cam, cfg: RenderConfig, rank_counts: Optional[Sequence[int]] = None,
                    samples_axis: int = 1, iters: int = 3, device=None) -> List[Dict]:
    """Time the sharded render on grids of the first n ranks, n in
    ``rank_counts`` (default 1, 2, 4, ... up to the world). Every rank of
    the world calls it; each returns the rows of the grids it was in (rank
    0: all of them). A row: {ranks, devices, mesh, seconds, mrays,
    efficiency}; efficiency is T(1) / (n T(n)) (fixed global work) where
    the n ranks have n devices, else None with a note."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if rank_counts is None:
        rank_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    rows: List[Dict] = []
    base = None
    for n in rank_counts:
        samples = samples_axis if n % samples_axis == 0 and n >= samples_axis else 1
        mesh = make_mesh(tiles=n // samples, samples=samples, ranks=range(n), device=device)
        if mesh is not None:
            secs = time_call(lambda m=mesh: render_channels_sharded(scene, cam, cfg, m),
                             mesh.device, iters)
            base = secs if base is None else base
            n_dev = distinct_devices(n, mesh.device)
            row = {"ranks": n, "devices": n_dev, "mesh": dict(mesh.shape), "seconds": secs,
                   "mrays": mrays_per_sec(cfg.width, cfg.height, cfg.spp, cfg.max_bounces,
                                          secs),
                   "efficiency": base / (n * secs) if n_dev == n else None}
            if n_dev != n:
                row["note"] = SHARED_DEVICE_NOTE
            rows.append(row)
            _barrier(mesh.device)
        else:
            from pathtrace_tpu_torch.parallel.mesh import rank_device

            _barrier(rank_device(device))
    return rows


def _scaling_rank(size: int, spp: int, backend: str, iters: int, device=None):
    from pathtrace_tpu_torch import Camera, cornell_box

    cfg = RenderConfig(width=size, height=size, spp=spp, backend=backend)
    return measure_scaling(cornell_box(), Camera.create(), cfg, iters=iters, device=device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Measure scaling over a world of one rank a card (or ``--ranks`` on
    the CPU) and print the efficiency record (one JSON line with --json)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--json", action="store_true", help="one-line JSON record")
    ap.add_argument("--backend", default="auto", help="render backend (auto/cuda/torch)")
    ap.add_argument("--device", default=None, help='"cpu" to run on the CPU')
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the world (default: one a card; 1 on the CPU)")
    args = ap.parse_args(argv)

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device available; pass --device cpu to run on the CPU')
    n = args.ranks or (1 if cpu else torch.cuda.device_count())
    world_backend = choose_backend(n, args.device)
    rows = launch(_scaling_rank, n, args.size, args.spp, args.backend, args.iters,
                  device=args.device, quiet=args.json)[0]
    n_dev = rows[-1]["devices"]
    eff = rows[-1]["efficiency"]
    record = {
        "metric": f"scaling efficiency (Cornell {args.size}^2 x {args.spp}spp)",
        "backend": "cpu" if cpu else "cuda",
        "device": "cpu" if cpu else torch.cuda.get_device_name(0),
        "world_backend": world_backend,
        "num_hosts": 1,
        "num_ranks": n,
        "num_devices": n_dev,
        "results": rows,
        "efficiency_at_max": eff,
        # The 80% gate is about several devices; on one, efficiency is 1.0
        # by construction, and ranks sharing a device measure the harness.
        "gate_80pct": eff >= 0.8 if n_dev > 1 and eff is not None else None,
        "gate_reason": (None if n_dev > 1 and eff is not None else
                        "single device: efficiency trivially 1.0; the gate needs >=2 devices"),
    }
    if args.json:
        print(json.dumps(record))
    else:
        for r in rows:
            eff_s = "n/a" if r["efficiency"] is None else f"{r['efficiency']:.2%}"
            print(f"ranks={r['ranks']:>3} devices={r['devices']} mesh={r['mesh']} "
                  f"{r['mrays']:.0f} Mrays/s eff={eff_s}" + (f" ({r['note']})" if "note" in r
                                                            else ""))
        gate = ("not applicable (single device)" if record["gate_80pct"] is None
                else ("PASS" if record["gate_80pct"] else "FAIL"))
        print(f"efficiency at {n} ranks on {n_dev} device(s): gate >=80%: {gate}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
