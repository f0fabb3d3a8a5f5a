"""What holds the forward trace kernel (K1) and the product-chain gradient
kernel (K2 fused and dump, K5 replay) back on the card: the compiler's
report, the instruction mix, resident blocks, the occupancy curve, times at
the main path's shapes, and the digests of their outputs.

    python scripts/torch_kernel_occupancy.py [--iters 20] [--skip-report]
        [--skip-curve] [--digests] [--root DIR] [--label NAME]

Needs one CUDA device and nvcc. Prints, beside the card's name and power
limit:

1. ``nvcc -Xptxas -v`` of ``trace_kernel.cu`` and ``grad_kernel.cu`` (and of
   the NEE and all-parameter kernels, whose registers must not move when
   ``common.cuh`` changes): registers, stack frame, spill stores and loads.
2. From ``cuobjdump -sass``, by kernel: static counts of ``LDC`` with a
   register index (a constant-bank load whose address differs by lane is
   serialised), ``LDS``/``STS``, ``MUFU`` by function, calls (the slow paths
   of ``sqrtf``, ``sinf``, ``cosf``), the integer ``IMAD``/``LOP3``/``SHF``
   of the lattice hashing, ``SHFL``, ``BRA``, global stores; and a sha256 of
   each kernel's instruction text, which says whether two builds compiled a
   kernel to the same code.
3. Resident blocks an SM, registers, shared and local bytes of K1's twelve
   variants and K2's three modes at 8x8 and 16x16 pixels a block.
4. The occupancy curve (unless ``--skip-curve``): K1's NEE colour sums at
   256x256x16 and K2's dump at 256x256x8, with the dynamic shared memory
   padded so that 1, 2, ... blocks are resident on an SM, each timed with
   CUDA events. A time that falls as 1/blocks says more resident warps
   would pay; a curve that flattens says they would not.
5. Times at the main path's shapes, by CUDA events (median of ``--iters``
   single launches, the host's launch gap included) and by ``torch.profiler``
   (device time of the kernel alone over ``--iters`` launches): K1's 14
   channels at 512x512x4 and 512x512x32, its colour sums at 256x256x16 NEE
   and 256x256x8 glossy; K2's dump at 256x256x8, fused and K5 at 512x512x32;
   K3 fused and replay at 512x512x32 NEE, K4 against a colour cotangent at
   512x512x32 glossy and NEE diffuse, and K1's NEE colour sums there (the
   two launches of the bench's ``vjp_fwd_bwd_mrays``). A tree whose kernels
   take their blocks as device arrays (``trace_kernel.stage_blocks``) is
   given them there once; an older tree takes them on the host.
6. With ``--digests``: ``chip_smoke.kernel_digests`` (the bit gate of phase
   17) and K1's max |kernel - plain| on the twelve cases of phase 3.

``--root DIR`` examines the kernels of another checkout (a ``git archive``
of another commit) with this script and this tree's ``chip_smoke.py``. The
result also goes to ``chiprun_out/kernel_occupancy_<label>.json``. To
compare two trees, run one process each in turns (parent, change, change,
parent) in one call on the chip.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = (Path(sys.argv[sys.argv.index("--root") + 1]).resolve() if "--root" in sys.argv
        else HERE)
sys.path.insert(0, str(ROOT))

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box  # noqa: E402
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak  # noqa: E402
from pathtrace_tpu_torch.ops import build  # noqa: E402
from pathtrace_tpu_torch.ops import grad_kernel as gk  # noqa: E402
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk  # noqa: E402
from pathtrace_tpu_torch.ops import trace_kernel as tk  # noqa: E402
from pathtrace_tpu_torch.utils.timing import device_name, time_fn  # noqa: E402


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep_occ = _load("torch_sweep_occupancy", HERE / "scripts" / "torch_sweep_occupancy.py")
chip_smoke = _load("chip_smoke", HERE / "chip_smoke.py")

SM_SHARED_BYTES = 233472  # 228 KB an SM on sm_90
BLOCK_RESERVED_BYTES = 1024  # what the system keeps of it for each resident block
SASS_PATTERNS = {
    "LDC[R]": r"\bLDC(\.\w+)*\s+\w+, c\[[^\]]+\]\[R\d+", "LDC": r"\bLDC\b",
    "ULDC": r"\bULDC\b", "LDS": r"\bLDS\b", "STS": r"\bSTS\b", "LDL": r"\bLDL\b",
    "STL": r"\bSTL\b", "STG": r"\bSTG\b", "MUFU": r"\bMUFU\b", "MUFU.RSQ": r"\bMUFU\.RSQ\b",
    "MUFU.SQRT": r"\bMUFU\.SQRT\b", "MUFU.RCP": r"\bMUFU\.RCP\b", "MUFU.SIN": r"\bMUFU\.SIN\b",
    "MUFU.COS": r"\bMUFU\.COS\b", "CALL": r"\bCALL\b", "IMAD": r"\bIMAD\b",
    "IMAD.MOV": r"\bIMAD\.MOV\b", "LOP3": r"\bLOP3\b", "SHF": r"\bSHF\b", "SHFL": r"\bSHFL\b",
    "BRA": r"\bBRA\b", "BAR": r"\bBAR\b", "WARPSYNC": r"\bWARPSYNC\b", "FMUL": r"\bFMUL\b",
    "FADD": r"\bFADD\b", "FFMA": r"\bFFMA\b", "FSETP": r"\bFSETP\b", "FSEL": r"\bFSEL\b",
}
SASS_RE = {k: re.compile(v) for k, v in SASS_PATTERNS.items()}


def sass_report(lib: Path):
    """{kernel: counts + "instructions" + "sha256"} from ``cuobjdump -sass``."""
    functions = build.sass_functions(lib)
    out = build.sass_counts(functions, SASS_RE)
    for name, lines in functions.items():
        out[name]["sha256"] = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip-report", action="store_true", help="no ptxas, SASS or occupancy")
    ap.add_argument("--skip-curve", action="store_true")
    ap.add_argument("--digests", action="store_true")
    ap.add_argument("--root", help="the checkout whose kernels are examined (default: this one)")
    ap.add_argument("--label", default="this")
    ap.add_argument("--lanes", type=int, help="sample lanes of every timed launch (default: the "
                    "wrappers' own; a tree without lanes takes none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_occupancy: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = device_name(dev)
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"[{args.label}] card: {card}; {nvcc}; kernels of {ROOT}"
          + (f"; {args.lanes} lanes" if args.lanes else ""))
    result = {"label": args.label, "card": card, "nvcc": nvcc}
    scene, cam = cornell_box(), Camera.create()
    sb, n = scene.packed(), scene.num_objects
    sources = (tk.SOURCE, gk.SOURCE, nk.SOURCE, ak.SOURCE)
    build.build_all(sources)

    if not args.skip_report:
        print("== ptxas -v: registers, stack frame, spill stores, spill loads (bytes)")
        result["ptxas"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            reports = {src: sweep_occ.ptxas_report(src, tmp) for src in sources}
        names = sweep_occ.demangle([r[0] for rows in reports.values() for r in rows])
        for src, rows in reports.items():
            for name, regs, stack, st, ld in rows:
                if "reduce_partials" in name:
                    continue
                print(f"  {names[name][:78]:78s} regs {regs:3d} stack {stack:4d} spill st {st} "
                      f"ld {ld}")
                result["ptxas"][names[name]] = dict(registers=regs, stack=stack,
                                                    spill_stores=st, spill_loads=ld)
        print("== SASS, static counts by kernel (sha256: of the instruction text)")
        result["sass"] = {}
        for src in sources:
            counts = sass_report(build.build_library(src))
            pretty = sweep_occ.demangle(list(counts))
            for name, c in counts.items():
                if "reduce_partials" in name:
                    continue
                shown = c if src in (tk.SOURCE, gk.SOURCE) else {
                    k: c[k] for k in ("instructions", "sha256")}
                print(f"  {pretty[name][:60]:60s} " + " ".join(f"{k} {v}" for k, v in
                                                              shown.items()))
                result["sass"][pretty[name]] = c
        print("== resident blocks an SM, registers, shared and local bytes")
        result["occupancy"] = {}
        for block in (8, 16):
            for brdf in ("diffuse", "glossy"):
                for nee in (False, True):
                    cfg = RenderConfig(block=block, brdf=brdf, nee=nee)
                    for mode in tk.MODES:
                        occ = tk.CUDA_KERNEL.occupancy(mode, cfg)
                        key = f"K1 {mode} {brdf}{' nee' if nee else ''} {block}x{block}"
                        result["occupancy"][key] = occ
                        print(f"  {key:36s} " + "  ".join(f"{k} {v}" for k, v in occ.items()))
            # the NEE colour passes that write the path tape
            for brdf in ("diffuse", "glossy"):
                occ = tk.CUDA_KERNEL.occupancy(
                    "color", RenderConfig(block=block, nee=True, brdf=brdf), taped=True)
                key = f"K1 color{' glossy' if brdf == 'glossy' else ''} nee taped {block}x{block}"
                result["occupancy"][key] = occ
                print(f"  {key:36s} " + "  ".join(f"{k} {v}" for k, v in occ.items()))
            for mode in gk.MODES:
                occ = gk.CUDA_KERNEL.occupancy(mode, RenderConfig(block=block), n)
                key = f"K2 {mode} {block}x{block}"
                result["occupancy"][key] = occ
                print(f"  {key:36s} " + "  ".join(f"{k} {v}" for k, v in occ.items()))

    cases = {
        "K1 channels 512x512x4": (RenderConfig(width=512, height=512, spp=4), "channels"),
        "K1 channels 512x512x32": (RenderConfig(width=512, height=512, spp=32), "channels"),
        "K1 color nee 256x256x16": (RenderConfig(width=256, height=256, spp=16, nee=True),
                                    "color"),
        "K1 color glossy 256x256x8": (RenderConfig(width=256, height=256, spp=8,
                                                   brdf="glossy"), "color"),
        "K2 dump 256x256x8": (RenderConfig(width=256, height=256, spp=8), "dump"),
        "K2 fused 512x512x32": (RenderConfig(width=512, height=512, spp=32), "fused"),
        "K5 replay 512x512x32": (RenderConfig(width=512, height=512, spp=32), "replay"),
        "K3 fused 512x512x32": (RenderConfig(width=512, height=512, spp=32, nee=True),
                                "nee fused"),
        "K3 replay 512x512x32": (RenderConfig(width=512, height=512, spp=32, nee=True),
                                 "nee replay"),
        "K4 glossy colour 512x512x32": (RenderConfig(width=512, height=512, spp=32,
                                                     brdf="glossy"), "ad"),
        "K1 color nee 512x512x32": (RenderConfig(width=512, height=512, spp=32, nee=True),
                                    "color"),
        "K4 nee colour 512x512x32": (RenderConfig(width=512, height=512, spp=32, nee=True),
                                     "ad"),
    }
    profiled = {"nee fused": "nee_grad_kernel", "nee replay": "nee_grad_kernel",
                "ad": "ad_grad_kernel"}

    def launcher(cfg, mode, pad=0):
        sbl, cb, seed = sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg)
        if hasattr(tk, "stage_blocks"):
            sbl, cb, seed = tk.stage_blocks((sbl, cb, tk.seed_array(seed)), dev)
        kw = dict(local_h=cfg.height, spp=cfg.spp, device=dev)
        px = None
        if mode not in tk.MODES and mode != "dump":
            px = torch.full((cfg.height, cfg.width, 3), 0.25 if "fused" in mode else 1e-6,
                            device=dev)
        if mode == "ad":
            ct = px.permute(2, 0, 1).contiguous()
            return lambda: ak.CUDA_KERNEL.launch(sbl, cb, seed, cfg, ct, **kw)
        if mode.startswith("nee "):
            return lambda: nk.CUDA_KERNEL.launch(mode[4:], sbl, cb, seed, cfg, px, **kw)
        kw["pad_shared"] = pad
        if args.lanes:
            kw["lanes"] = args.lanes
        if mode in tk.MODES:
            return lambda: tk.CUDA_KERNEL.launch(sbl, cb, seed, cfg, mode=mode, **kw)
        return lambda: gk.CUDA_KERNEL.launch(mode, sbl, cb, seed, cfg, px, **kw)

    if not args.skip_curve:
        print(f"== occupancy curve: dynamic shared memory padded; median of {args.iters} launches")
        result["curve"] = {}
        for key in ("K1 color nee 256x256x16", "K2 dump 256x256x8"):
            cfg, mode = cases[key]

            def occupancy(pad):
                if mode in tk.MODES:
                    return tk.CUDA_KERNEL.occupancy(mode, cfg, pad)
                return gk.CUDA_KERNEL.occupancy(mode, cfg, n, pad)

            base = occupancy(0)
            first = None
            for want in range(1, base["blocks_per_sm"] + 1):
                total = (SM_SHARED_BYTES // want - BLOCK_RESERVED_BYTES) // 128 * 128
                pad = total - base["shared_bytes"] if want < base["blocks_per_sm"] else 0
                if pad < 0:
                    continue
                occ = occupancy(pad)
                ms, _ = time_fn(launcher(cfg, mode, pad), warmup=2, iters=args.iters,
                                device=dev)
                med = statistics.median(ms)
                first = med if first is None else first
                print(f"  {key}: {occ['blocks_per_sm']:2d} blocks an SM: {med:.4f} ms (runs "
                      f"{min(ms):.4f}..{max(ms):.4f}); x{first / med:.2f} of one block")
                result["curve"][f"{key} blocks={occ['blocks_per_sm']}"] = med

    print(f"== times: CUDA events (median of {args.iters} single launches) and torch.profiler "
          f"(device time of the kernel alone, {args.iters} launches)")
    result["times"] = {}
    for key, (cfg, mode) in cases.items():
        fn = launcher(cfg, mode)
        ms, _ = time_fn(fn, warmup=3, iters=args.iters, device=dev)
        match = profiled.get(mode, "pathtrace_kernel" if mode in tk.MODES else "grad_kernel")
        prof, device_all = chip_smoke.kernel_profiler_ms(fn, args.iters, match)
        result["times"][key] = dict(events=statistics.median(ms), events_min=min(ms),
                                    events_max=max(ms), profiler=prof, device_all=device_all)
        print(f"  [{args.label}] {key:28s} events {statistics.median(ms):.4f} ms (runs "
              f"{min(ms):.4f}..{max(ms):.4f}); profiler {prof:.4f} ms (all device work "
              f"{device_all:.4f})")

    if args.digests:
        result["digests"] = chip_smoke.kernel_digests(dev, tk, gk)
        print("== digests (sha256 of the output bytes) against chip_smoke.KERNEL_DIGESTS")
        for k, v in result["digests"].items():
            same = "ok" if chip_smoke.KERNEL_DIGESTS.get(k) == v else "DIFFERS"
            print(f"  {k:34s} {v} {same}")
        result["k1_vs_plain"] = {}
        for case, extra in chip_smoke.DIGEST_CONFIGS.items():
            cfg = RenderConfig(width=128, height=96, spp=4, **extra)
            cb, seed = tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 0, 5, 16)
            for mode in tk.MODES:
                kw = dict(local_h=64, spp=4, mode=mode, device=dev)
                d = (tk.trace(sb, cb, seed, cfg, **kw) - tk.trace_plain(sb, cb, seed, cfg, **kw))
                result["k1_vs_plain"][f"{case} {mode}"] = float(d.abs().max())
        print(f"  K1 max |kernel - plain| at 128x64x4: {result['k1_vs_plain']}")

    out = HERE / "chiprun_out" / f"kernel_occupancy_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"written: {out.relative_to(HERE)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
