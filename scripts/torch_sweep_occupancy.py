"""What holds the shared reverse sweep (K3, K4) back on the card: the
compiler's report, the instruction mix, and the occupancy curve.

    python scripts/torch_sweep_occupancy.py [--iters 20] [--skip-sass]

Needs one CUDA device and nvcc. Prints, beside the card's name and power
limit:

1. ``nvcc -Xptxas -v`` for every kernel of ``csrc/``: registers, stack
   frame, spill stores and loads.
2. From ``cuobjdump -sass`` of the NEE and all-parameter kernels, by kernel:
   the count of ``LDC`` with a register index (a constant-bank load whose
   address differs by lane is serialised), ``LDL``/``STL`` (local memory),
   ``LDS``/``STS`` (shared memory), ``MUFU`` (the special-function unit),
   ``DADD``, the calls (the slow paths of ``sinf``/``cosf``) and the
   synchronisation of the lane turns (``WARPSYNC``, ``BSYNC``, ``BAR``,
   ``REDUX``). These are static counts over the whole kernel, forward loop
   included; ``--dump-sass DIR`` also writes the listings.
3. The occupancy curve: the NEE kernel's replay at 512x512x32 and
   256x256x16 with the dynamic shared memory padded so that 1, 2, ... blocks
   of 8x8 threads are resident on an SM (as the occupancy calculator then
   confirms), each timed with CUDA events. A time that falls as 1/blocks
   says the kernel waits on latency and more resident warps would pay; a
   curve that flattens says they would not.
4. Resident blocks, registers and shared bytes of every sweep instance at
   the default 8x8 block and at 16x16.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# --root DIR: examine the kernels of another checkout (a ``git archive`` of
# another commit) with this script; one without the occupancy hooks gets the
# compiler's report and the SASS counts only.
ROOT = (Path(sys.argv[sys.argv.index("--root") + 1]).resolve() if "--root" in sys.argv
        else Path(__file__).resolve().parents[1])
sys.path.insert(0, str(ROOT))

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box  # noqa: E402
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak  # noqa: E402
from pathtrace_tpu_torch.ops import build  # noqa: E402
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk  # noqa: E402
from pathtrace_tpu_torch.ops import trace_kernel as tk  # noqa: E402
from pathtrace_tpu_torch.utils.timing import device_name, time_fn  # noqa: E402

SM_SHARED_BYTES = 233472  # 228 KB an SM on sm_90
BLOCK_RESERVED_BYTES = 1024  # what the system keeps of it for each resident block
SASS_PATTERNS = {
    "LDC[R]": re.compile(r"\bLDC(\.\w+)*\s+\w+, c\[[^\]]+\]\[R\d+"),
    "LDL": re.compile(r"\bLDL\b"), "STL": re.compile(r"\bSTL\b"),
    "LDS": re.compile(r"\bLDS\b"), "STS": re.compile(r"\bSTS\b"),
    "MUFU": re.compile(r"\bMUFU\b"), "DADD": re.compile(r"\bDADD\b"),
    "CALL": re.compile(r"\bCALL\b"), "WARPSYNC": re.compile(r"\bWARPSYNC\b"),
    "BSYNC": re.compile(r"\bBSYNC\b"), "BAR": re.compile(r"\bBAR\b"),
    "REDUX": re.compile(r"\bREDUX\b"), "NOP": re.compile(r"\bNOP\b"),
}


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool, *names], capture_output=True, text=True).stdout.split("\n")
    return {n: re.sub(r"\(.*", "", d) for n, d in zip(names, out)}


def ptxas_report(source: Path, out_dir: str):
    """[(kernel, registers, stack, spill stores, spill loads)] of ``source``."""
    proc = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(Path(out_dir) / (source.stem + ".so")), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    rows, name, frame = [], None, (0, 0, 0)
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *frame))
            name = None
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip-sass", action="store_true")
    ap.add_argument("--dump-sass", help="write cuobjdump's listing of each library here")
    ap.add_argument("--root", help="the checkout whose kernels are examined (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_occupancy: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_name(dev)
    print(f"card: {card}")
    result = {"card": card}

    print("== ptxas -v: registers, stack frame, spill stores, spill loads (bytes)")
    sources = sorted(build.CSRC.glob("*.cu"))
    result["ptxas"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        reports = {src: ptxas_report(src, tmp) for src in sources}
    names = demangle([r[0] for rows in reports.values() for r in rows])
    for src, rows in reports.items():
        for name, regs, stack, st, ld in rows:
            print(f"  {src.name:20s} {names[name][:70]:70s} regs {regs:3d}  stack {stack:4d}  "
                  f"spill st {st} ld {ld}")
            result["ptxas"][names[name]] = dict(registers=regs, stack=stack, spill_stores=st,
                                                spill_loads=ld)

    if not args.skip_sass:
        print("== SASS, static counts by kernel")
        result["sass"] = {}
        for mod in (nk, ak):
            counts = build.sass_counts(build.sass_functions(build.build_library(mod.SOURCE),
                                                             args.dump_sass), SASS_PATTERNS)
            pretty = demangle(list(counts))
            for name, c in counts.items():
                if "reduce_partials" in name:
                    continue
                print(f"  {pretty[name][:60]:60s} " + "  ".join(f"{k} {v}" for k, v in c.items()))
                result["sass"][pretty[name]] = c

    if not hasattr(nk.CUDA_KERNEL, "occupancy"):
        print(json.dumps(result))
        return 0
    print("== resident blocks an SM, registers, shared and local bytes, by instance")
    scene, cam = cornell_box(), Camera.create()
    n = scene.num_objects
    result["instances"] = {}
    for block in (8, 16):
        rows = {f"K3 {mode}": nk.CUDA_KERNEL.occupancy(mode, block, n) for mode in nk.MODES}
        rows.update(ak.CUDA_KERNEL.instances(block, n))
        for name, occ in rows.items():
            print(f"  {block:2d}x{block:<2d} {name:28s} " + "  ".join(f"{k} {v}" for k, v in
                                                                     occ.items()))
            result["instances"][f"{name} {block}x{block}"] = occ

    print(f"== occupancy curve: K3 replay, 8x8 blocks, median of {args.iters} launches")
    sb = scene.packed()
    base = nk.CUDA_KERNEL.occupancy("replay", 8, n)
    result["curve"] = {}
    for size, spp in ((512, 32), (256, 16)):
        cfg = RenderConfig(width=size, height=size, spp=spp, nee=True)
        sbl, cb, seed = sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg)
        if hasattr(tk, "stage_blocks"):  # kernels that take their blocks as device arrays
            sbl, cb, seed = tk.stage_blocks((sbl, cb, tk.seed_array(seed)), dev)
        ct = torch.full((size, size, 3), 1e-6, device=dev)
        kw = dict(local_h=size, spp=spp, device=dev)
        first = None
        for want in range(1, base["blocks_per_sm"] + 1):
            total = (SM_SHARED_BYTES // want - BLOCK_RESERVED_BYTES) // 128 * 128
            pad = total - base["shared_bytes"] if want < base["blocks_per_sm"] else 0
            if pad < 0:
                continue
            occ = nk.CUDA_KERNEL.occupancy("replay", 8, n, pad)
            ms, _ = time_fn(lambda: nk.CUDA_KERNEL.launch("replay", sbl, cb, seed, cfg, ct,
                                                          pad_shared=pad, **kw),
                            warmup=2, iters=args.iters, device=dev)
            med = statistics.median(ms)
            first = med if first is None else first
            print(f"  {size}x{size}x{spp}: {occ['blocks_per_sm']:2d} blocks an SM "
                  f"({2 * occ['blocks_per_sm']:2d} warps, {occ['shared_bytes']} shared bytes a "
                  f"block): {med:.4f} ms (runs {min(ms):.4f}..{max(ms):.4f}); x"
                  f"{first / med:.2f} of the first")
            result["curve"][f"{size}x{spp} blocks={occ['blocks_per_sm']}"] = med
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
