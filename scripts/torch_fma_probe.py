"""The FMA question on the card: does a fused ``x*a+b`` cost one issue slot or two?

The port of scripts/fma_probe.py. The bounds of the port divide counted
operations by K6's FMA peak (``roofline.measure_f32_peak``), and that peak
and K7's latencies come from one compiler, nvcc, whose contraction the
probe kernel decides by intrinsic (``csrc/probe_kernel.cu``: ``__fmaf_rn``
for one fused op, ``__fmul_rn`` then ``__fadd_rn`` for two, under
``-fmad=false``). This script runs the same chains through a second,
independent code generator with no hand-written kernel, as the JAX script
ran them through plain XLA beside Mosaic:

1. The compiled leg (``compiled_chain_rate``, the counterpart of
   ``xla_chain_rate``): ``chains`` chains an element of ``inner`` dependent
   steps of ``mul``, ``add`` or ``fma``, on run-time coefficients. One trip
   (every chain ``inner`` steps) is ``torch.compile(fullgraph=True,
   dynamic=False)`` of plain tensor code: Inductor, then Triton and ptxas
   on a card (Inductor's C++ on the CPU). It is called ``iters`` times, so
   the chains go through memory once a trip, as JAX's ``fori_loop`` carry
   does; the whole run is not compiled, since 64 trips unrolled would be
   131k operations in one graph. Each mode's compiled trip is then held
   against the eager trip (``trip_error``, within ``TRIP_RTOL``) on inputs
   where every op moves the result; a miss is an error. Which kernels
   Inductor wrote for a trip, how many stores they make, the seconds of the
   leg with its compile, the trip's difference from the eager one, and on a
   card the SASS counts of ``FFMA``, ``FMUL``, ``FADD`` and ``STG`` of the
   cubins Triton built, go into the record (``compiled_trip``), beside the
   same counts of the probe kernel's instances (``probe_sass``).
2. K6 (``roofline.measure_f32_peak``): the hand-written chains' FMA and
   multiply-only rates.
3. K7 (``roofline.latency_probe``): one dependent chain a thread in six
   modes, 32,768 trips x 32 steps (the JAX script's 2,048 x 512), and the
   discriminator (``derived``): if ``x*a+b`` is one instruction its step
   costs what ``mul``'s does, if two what ``add_add``'s does. On a card the
   SM clock read right after it turns ns a step into cycles.

The shape. The JAX script's (512, 128) was sized for a v5e. On an H100 a
trip at that size is 65,536 x 8 x 256 = 134 M chain-ops, ~4 us at K6's
~33 T chain-ops/s: the order of one launch, so the leg would time launches.
The port takes K6's element count, ``SHAPE`` = (2048 x 64, 128), 16.8 M
elements. A trip there reads and writes the chains once, 16.8 M x 8 chains
x 8 bytes = 1.07 GB, ~0.32 ms at 3.35 TB/s, against ~1.0 ms of compute at
33 T chain-ops/s: compute-bound by ~3x on this card, not by the ~25x that
the JAX script reckons for the TPU.

``per_issued_op_latency_ns`` keeps the JAX record's formula, (fma_fma -
fma) / 2, which assumes an fma of two issued ops. Where
``fma_single_slot`` is true, fma_fma is two fused ops against fma's one, so
the key reads half of one op's latency there.

The record has every key of docs/fma_probe_r5.json (the TPU's record), the
compiled leg's rates under the ``xla_*`` keys and K6's under ``pallas_*``,
with ``backend`` "cuda", and adds ``device`` (name and power limit),
``shape``, ``kernel_launches`` (K6's and K7's launches, counted from 0),
``compiled_trip``, ``probe_sass``, ``sm_clock_mhz`` and
``latency_cycles_per_step``.

It runs on the current CUDA device, or ``--device N``; without CUDA and
without ``--device cpu`` it exits 1. With ``--device cpu`` K6 and K7 run
their plain versions by the host clock, for hours at their depths: that is
for tests, which shorten them. A failure of ``torch.compile`` is an error.

Usage, from the root of a checkout:

    python scripts/torch_fma_probe.py [--json out.json] [--iters 64] [--inner 256]
        [--chains 8] [--device N|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtrace_tpu_torch.cli import device_arg  # noqa: E402
from pathtrace_tpu_torch.ops import build  # noqa: E402
from pathtrace_tpu_torch.render import resolve_device  # noqa: E402
from pathtrace_tpu_torch.utils import roofline as rf  # noqa: E402
from pathtrace_tpu_torch.utils.timing import best_seconds, device_name  # noqa: E402

MODES = ("mul", "add", "fma")
# K6's element count (see the docstring): compute-bound on the card.
SHAPE = (rf.PEAK_GRID * 64, 128)
SASS_RE = {op: re.compile(rf"\b{op}\b") for op in ("FFMA", "FMUL", "FADD", "STG")}
# The compiled trip against the eager one (``trip_error``): ``mul`` and
# ``add`` are the same IEEE op at each step, so to the bit; ``fma`` within
# 1e-4, since one rounding (a contracted FFMA) against two at each of 256
# steps parts them by <= 256 x 6e-8 = 1.5e-5. A step or an op missing moves
# some element by 1e-2 or more.
TRIP_RTOL = {"mul": 0.0, "add": 0.0, "fma": 1e-4}


# -- the chain ----------------------------------------------------------------------

def chain_step(x, a, b, mode: str):
    """One step: ``mul`` x*a, ``add`` x+b, ``fma`` x*a+b (one op or two)."""
    if mode == "mul":
        return x * a
    if mode == "add":
        return x + b
    if mode == "fma":
        return x * a + b
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def chain_trip(xs, a, b, mode: str, inner: int):
    """One trip: ``inner`` dependent steps of every chain. ``xs`` holds the
    chains side by side in its last dimension, ``a`` and ``b`` one value an
    element there (a last dimension of 1), so a step is one tensor op for
    all chains (JAX's ``_chain_body`` on each chain of its tuple)."""
    for _ in range(inner):
        xs = chain_step(xs, a, b, mode)
    return xs


def make_trip(mode: str, inner: int):
    """``trip(xs, a, b)``: ``chain_trip`` with its mode and depth bound, the
    function that ``torch.compile`` takes."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    def trip(xs, a, b):
        return chain_trip(xs, a, b, mode, inner)

    return trip


def chain_run(x, a, mode: str, *, iters: int, inner: int, chains: int, trip=None):
    """The JAX script's ``run`` (fma_probe.py:71-83): ``b`` = x * 1e-7, the
    chains' starts x * (1 + 0.001 c), ``iters`` trips, then the chains summed
    in order. The chains are stacked in a last dimension, where JAX keeps a
    tuple: the same values, and a trip of ``inner`` graph nodes a mode, not
    ``chains`` x ``inner`` (the compile cost grows with the nodes). ``trip``:
    the trip to call (``make_trip``'s, eagerly, by default; a compiled one
    in ``compiled_chain_rate``)."""
    trip = make_trip(mode, inner) if trip is None else trip
    b = x * np.float32(1e-7)
    xs = torch.stack([x * (1.0 + 0.001 * c) for c in range(chains)], dim=-1)
    a1, b1 = a.unsqueeze(-1), b.unsqueeze(-1)
    for _ in range(iters):
        xs = trip(xs, a1, b1)
    acc = xs[..., 0]
    for c in range(1, chains):
        acc = acc + xs[..., c]
    return acc


def compile_trip(mode: str, inner: int):
    """``make_trip``'s trip through ``torch.compile``, one graph of fixed shapes."""
    return torch.compile(make_trip(mode, inner), fullgraph=True, dynamic=False)


def compiled_chain_rate(mode: str, *, iters: int = 64, inner: int = 256, chains: int = 8,
                        shape=SHAPE, reps: int = 3, device=None, trip=None) -> float:
    """Chain-ops/s of the compiled chain (one ``x*a+b`` counts as ONE
    chain-op; twice that for FMA flop credit): ``chain_run`` with its trip
    through ``torch.compile`` (``trip``, or ``compile_trip``'s), the best of
    ``reps`` runs after one (which compiles), CUDA-event-timed on a card
    (``timing.best_seconds``)."""
    device = resolve_device(device)
    x = torch.ones(shape, dtype=torch.float32, device=device)
    a = torch.full_like(x, 0.9999999)
    trip = compile_trip(mode, inner) if trip is None else trip
    best = best_seconds(lambda: chain_run(x, a, mode, iters=iters, inner=inner, chains=chains,
                                          trip=trip), reps, device)
    return x.numel() * iters * inner * chains / best


def trip_error(trip, mode: str, *, inner: int, chains: int, shape=SHAPE, device=None,
               rows: int = 64) -> float:
    """The largest relative difference between ``trip`` (a compiled one) and
    ``make_trip``'s eager trip on the first ``rows`` rows, on seeded inputs at
    the shapes ``chain_run`` gives a trip, where every op moves the result: x
    in [1, 2), a in [0.99, 1), b in [0.01, 0.02). The inputs of ``chain_run``
    itself (b = 1e-7 x, under one ulp of x) could not tell a dropped ``+b``
    from a rounding."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)

    def uniform(lo, width, last):
        return lo + width * torch.rand((*shape, last), generator=g, device=device)

    xs, a, b = uniform(1.0, 1.0, chains), uniform(0.99, 0.01, 1), uniform(0.01, 0.01, 1)
    got = trip(xs, a, b)[:rows]
    want = make_trip(mode, inner)(xs[:rows], a[:rows], b[:rows])
    return ((got - want).abs() / want.abs()).max().item()


# -- the discriminator ------------------------------------------------------------------

def derived(lat: dict) -> dict:
    """The record's four derived fields from the latencies (ns a step by
    mode), as fma_probe.py:204-215 computes them. The one-op control is
    ``mul``, the two-op control ``add_add``: ``fma_single_slot`` says which
    ``fma`` lies nearer."""
    return {
        "latency_fma_over_mul": lat["fma"] / lat["mul"],
        "latency_two_stmt_over_mul": lat["mul_then_add"] / lat["mul"],
        "fma_single_slot": bool(abs(lat["fma"] - lat["mul"]) < abs(lat["fma"] - lat["add_add"])),
        "per_issued_op_latency_ns": (lat["fma_fma"] - lat["fma"]) / 2.0,
    }


# -- what was compiled --------------------------------------------------------------------

@contextlib.contextmanager
def private_compile_cache():
    """Inductor's and Triton's caches in a fresh temporary directory for the
    block (so every trip is compiled here, and its cubins can be read); the
    environment is restored after. Yields the directory."""
    keys = ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")
    saved = {k: os.environ.get(k) for k in keys}
    with tempfile.TemporaryDirectory(prefix="torch_fma_probe_") as tmp:
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(tmp, "inductor")
        os.environ["TRITON_CACHE_DIR"] = os.path.join(tmp, "triton")
        try:
            yield tmp
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def code_report(sources) -> dict:
    """Kernels and stores in the modules Inductor generated: Triton kernels
    (``async_compile.triton``) or C++ ones, and their ``.store(`` calls."""
    text = "\n".join(sources)
    return {"kernels": len(re.findall(r"async_compile\.(?:triton|cpp_pybinding|cpp)\(", text)),
            "stores": text.count(".store(")}


def probe_sass() -> dict:
    """The SASS counts of K6's and K7's instances in the built probe library,
    by the record's names: ``peak[fma]``, ``latency[mul_then_add]``, ..."""
    out = {}
    functions = build.sass_functions(build.library_path(rf.SOURCE))
    for fn, counts in build.sass_counts(functions, SASS_RE).items():
        m = re.search(r"chain_kernelILi(\d)ELi(\d)E", fn)
        if m:
            mode, chains = rf.LATENCY_MODES[int(m.group(1))], int(m.group(2))
            out[f"{'latency' if chains == 1 else 'peak'}[{mode}]"] = counts
    return out


def sm_clocks(device) -> dict:
    """The SM clock now and its highest, MHz, as nvidia-smi reads them."""
    proc = subprocess.run(["nvidia-smi", "-i", str(device.index),
                           "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          timeout=30)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    now, top = (float(v) for v in proc.stdout.splitlines()[0].split(","))
    return {"clocks.sm": now, "clocks.max.sm": top}


# -- the run -------------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the record here")
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--inner", type=int, default=256)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--device", type=device_arg, default=None,
                    help="CUDA device index, or 'cpu' (default: the current CUDA device)")
    return ap


def main(argv=None) -> int:
    from torch._inductor import config as inductor_config
    from torch._inductor.utils import run_and_get_code

    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_fma_probe: {e}", file=sys.stderr)
        return 1
    on_card = dev.type == "cuda"
    if on_card:
        dev = torch.device("cuda", dev.index if dev.index is not None else 0)
        torch.cuda.set_device(dev)
    kw = dict(iters=args.iters, inner=args.inner, chains=args.chains)
    rec = {"backend": dev.type, **kw}
    print(f"device: {device_name(dev)}; torch {torch.__version__}; shape {list(SHAPE)}")

    trips = {}
    # One compile at a time, in this process: a trip is one graph.
    with inductor_config.patch(compile_threads=1), private_compile_cache() as cache:
        for mode in MODES:
            cubins = set(glob.glob(os.path.join(cache, "**", "*.cubin"), recursive=True))
            t0 = time.perf_counter()
            trip = compile_trip(mode, args.inner)
            rate, sources = run_and_get_code(compiled_chain_rate, mode, shape=SHAPE,
                                             device=dev, trip=trip, **kw)
            trips[mode] = dict(code_report(sources), seconds=time.perf_counter() - t0)
            err = trip_error(trip, mode, inner=args.inner, chains=args.chains, device=dev)
            trips[mode].update(max_rel_err=err, rtol=TRIP_RTOL[mode])
            if not err <= TRIP_RTOL[mode]:
                raise RuntimeError(f"the compiled {mode} trip is {err:.3g} from the eager one "
                                   f"(rtol {TRIP_RTOL[mode]})")
            if on_card:
                new = sorted(set(glob.glob(os.path.join(cache, "**", "*.cubin"),
                                           recursive=True)) - cubins)
                trips[mode]["sass"] = {
                    f"{Path(p).parent.name[:12]}/{fn}": c for p in new
                    for fn, c in build.sass_counts(build.sass_functions(p), SASS_RE).items()}
            rec[f"xla_{mode}_ops_per_s"] = rate
            print(f"compiled {mode:>3} chain: {rate / 1e12:.3f} T chain-ops/s"
                  + ("  (= %.3f TFLOP/s FMA-credited)" % (2 * rate / 1e12)
                     if mode == "fma" else "")
                  + f"; {trips[mode]['kernels']} kernel(s), {trips[mode]['stores']} store(s) "
                    f"a trip; {trips[mode]['seconds']:.1f} s with the compile; a trip "
                    f"{err:.3g} from the eager one")
    # If the three compiled rates are about equal and far below K6's, the
    # leg is held back by something else than its instructions, and its
    # fma/mul ratio says nothing of slots: the latency probe decides.

    # The hand-written chains, measured in the same process.
    for k in rf.CUDA_KERNEL.launches:
        rf.CUDA_KERNEL.launches[k] = 0
    peaks = rf.measure_f32_peak(device=dev)
    rec["pallas_mul_ops_per_s"] = peaks["peak_mul_flops"]
    rec["pallas_fma_flops_per_s"] = peaks["peak_fma_flops"]
    print(f"K6 mul chain: {peaks['peak_mul_flops'] / 1e12:.3f} T chain-ops/s")
    print(f"K6 fma chain: {peaks['peak_fma_flops'] / 2e12:.3f} T chain-ops/s"
          f"  (= {peaks['peak_fma_flops'] / 1e12:.3f} TFLOP/s FMA-credited)")

    # The discriminator: one dependent chain a thread, no instruction-level
    # parallelism.
    lat = rf.latency_probe(device=dev)
    clocks = sm_clocks(dev) if on_card else None
    rec["latency_ns_per_step"] = lat
    print(f"\nDependent-chain latency (ns/step, K7: one chain a thread, "
          f"{rf.LATENCY_GRID * 8 * 128} threads):")
    for k, v in lat.items():
        print(f"  {k:>12}: {v:7.3f}")
    rec.update(derived(lat))
    rec.update(device=device_name(dev), shape=list(SHAPE),
               kernel_launches=dict(rf.CUDA_KERNEL.launches), compiled_trip=trips,
               probe_sass=probe_sass() if on_card else None, sm_clock_mhz=clocks,
               latency_cycles_per_step=None if clocks is None else
               {k: v * clocks["clocks.sm"] / 1e3 for k, v in lat.items()})
    fused = rec["fma_single_slot"]
    print(f"\nfma {lat['fma']:.2f} ns vs one-op control (mul) {lat['mul']:.2f} ns vs two-op "
          f"control (add_add) {lat['add_add']:.2f} ns; per-issued-op increment "
          f"{rec['per_issued_op_latency_ns']:.2f} ns (fma_fma line"
          + (", half of one op's latency where fma is one op) -> " if fused else ") -> ")
          + ("FUSED: x*a+b retires as one instruction whose dependent step costs one op's "
             "latency" if fused else
             "TWO issued ops: x*a+b costs two instructions' latency on this device"))
    if clocks is not None:
        print(f"SM clock right after: {clocks['clocks.sm']:.0f} MHz (max "
              f"{clocks['clocks.max.sm']:.0f}); cycles a step: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["latency_cycles_per_step"].items()))
    print(f"kernel launches: {rec['kernel_launches']}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
