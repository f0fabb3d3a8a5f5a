"""What holds the shared reverse sweep (K3, K4) back on the card: the
compiler's report, the instruction mix, and the occupancy curve.

    python scripts/torch_sweep_occupancy.py [--iters 20] [--skip-sass] [--root DIR] [--seed N]

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
   Then the same counts over the bounce loop alone of the two taped
   replays (K3's, K4's NEE glossy colour one): the innermost loop that
   holds the ring's ``LDGSTS``, where the lane pair adds a bounce's terms.
3. The occupancy curve: the NEE kernel's replay at 512x512x32 and
   256x256x16 with the dynamic shared memory padded so that 1, 2, ... blocks
   of 8x8 threads are resident on an SM (as the occupancy calculator then
   confirms), each timed with CUDA events. A time that falls as 1/blocks
   says the kernel waits on latency and more resident warps would pay; a
   curve that flattens says they would not.
4. Resident blocks, registers and shared bytes of every sweep instance at
   the default 8x8 block and at 16x16.
5. The collision shares of each inverse cell's first slab
   (``sweep.lane_pair_shares`` of the path tape its first colour pass
   writes, the cell's case from ``benchmark/configs/``): by bounce and over
   all, the share of a pair's bounces whose two lanes add to one slot,
   because they hit the same sphere or a lane hit the light. They decide
   how often the pass's two lanes meet in a slot.
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
from pathtrace_tpu_torch.ops import sweep  # noqa: E402
from pathtrace_tpu_torch.ops import trace_kernel as tk  # noqa: E402
from pathtrace_tpu_torch.utils.timing import device_name, time_fn  # noqa: E402

SM_SHARED_BYTES = 233472  # 228 KB an SM on sm_90
BLOCK_RESERVED_BYTES = 1024  # what the system keeps of it for each resident block
# The taped replays, by their mangled names: K3's REPLAY_TAPED and K4's NEE
# glossy colour-only TAPED instance, bounded for 8 x 8 blocks.
TAPED_KERNELS = {"K3 replay taped": "nee_grad_kernelILi2ELb1E",
                 "K4 nee_glossy colour taped": "ad_grad_kernelILb1ELb1ELb0ELb1ELb1E"}
LOOP_KEYS = ("LDS", "STS", "DADD", "SHFL", "WARPSYNC", "BSYNC")
_ADDRESSED = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(r"\bBRA\b[^;]*?0x([0-9a-f]+)")
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


def sass_listing(text: str) -> dict:
    """{function: [(address, instruction)]} of a ``cuobjdump -sass``
    listing."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _ADDRESSED.match(line)
        if name is not None and m:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def bounce_loop(instructions: list) -> list:
    """The instructions of the innermost loop (from a branch's earlier target
    to the branch) that holds an ``LDGSTS``: the taped sweep's bounce loop,
    whose ring copies the next bounce's words. [] where there is none."""
    best = []
    for address, text in instructions:
        m = _BRANCH.search(text)
        if m is None or int(m.group(1), 16) > address:
            continue
        body = [i for a, i in instructions if int(m.group(1), 16) <= a <= address]
        if any("LDGSTS" in i for i in body) and (not best or len(body) < len(best)):
            best = body
    return best


def loop_counts(listing: dict) -> dict:
    """{taped kernel: static counts of LOOP_KEYS over its bounce loop, and
    its instructions} of a ``sass_listing``."""
    out = {}
    for label, mangled in TAPED_KERNELS.items():
        for name, instructions in listing.items():
            if mangled in name:
                body = bounce_loop(instructions)
                out[label] = {**{k: sum(1 for i in body if re.search(rf"\b{k}\b", i))
                                 for k in LOOP_KEYS}, "instructions": len(body)}
    return out


def collision_shares(dev, cell: str, seed: int) -> dict:
    """``sweep.lane_pair_shares`` of the path tape that the first colour pass
    of the inverse cell's first step writes for its first slab, from the
    corrupted scene of the cell's case (``benchmark/configs/<cell>.json``).
    -> {"by_bounce": {key: [share a bounce]}, key: share over every pair's
    bounce}."""
    import numpy as np

    from pathtrace_tpu_torch.ops import sweep
    from pathtrace_tpu_torch.scene import Scene

    config = json.loads((ROOT / "benchmark" / "configs" / f"{cell}.json").read_text())
    r, c = config["render"], config["inverse"]
    rows = config["scene"]["spheres"]
    rad = np.array([s["radius"] for s in rows], np.float32)
    pos = np.array([s["position"] for s in rows], np.float32)
    rad[c["sphere"]] *= np.float32(c["radius_scale"])
    pos[c["sphere"]] += np.array(c["offset"], np.float32)
    scene = Scene(rad, pos, np.array([s["emission"] for s in rows], np.float32),
                  np.array([s["albedo"] for s in rows], np.float32))
    cfg = RenderConfig(width=r["width"], height=r["height"], spp=c["spp"],
                       max_bounces=r["max_bounces"], nee=r["nee"], brdf=r["brdf"],
                       light_index=r["light_index"], push_ray_origin=r["push_ray_origin"],
                       seed=seed)
    cam = Camera.create(c["camera"][:3], c["camera"][3], c["camera"][4])
    rows = sweep.slab_rows(cfg)  # the first slab's: step 0, frame 0, row 0
    tape = sweep.PathTape.empty(cfg, rows, cfg.spp, dev)
    blocks = tk.stage_blocks((scene.packed(), tk.camera_block(cam, cfg),
                              tk.seed_array(tk.make_seed_block(cfg))), dev)
    tk.trace(*blocks, cfg, mode="color", tape=tape, local_h=rows, spp=cfg.spp, device=dev)
    got = sweep.lane_pair_shares(tape.words, cfg.light_index)
    pairs = got.pop("pairs").double()
    out = {k: float((v * pairs).sum() / pairs.sum()) for k, v in got.items()}
    out["by_bounce"] = {k: [round(float(x), 6) for x in v] for k, v in got.items()}
    out["rows"] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip-sass", action="store_true")
    ap.add_argument("--dump-sass", help="write cuobjdump's listing of each library here")
    ap.add_argument("--root", help="the checkout whose kernels are examined (default: this one)")
    ap.add_argument("--seed", type=int, default=0, help="the render seed of the collision shares")
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
        result["sass"], result["bounce_loop"] = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            dump = args.dump_sass or tmp
            for mod in (nk, ak):
                lib = build.build_library(mod.SOURCE)
                counts = build.sass_counts(build.sass_functions(lib, dump), SASS_PATTERNS)
                pretty = demangle(list(counts))
                for name, c in counts.items():
                    if "reduce_partials" in name:
                        continue
                    print(f"  {pretty[name][:60]:60s} " + "  ".join(f"{k} {v}" for k, v in
                                                                    c.items()))
                    result["sass"][pretty[name]] = c
                listing = sass_listing((Path(dump) / (lib.stem + ".sass")).read_text())
                result["bounce_loop"].update(loop_counts(listing))
        print("== the taped replays' bounce loop, static counts")
        for label, c in result["bounce_loop"].items():
            print(f"  {label:28s} " + "  ".join(f"{k} {v}" for k, v in c.items()))

    if not hasattr(nk.CUDA_KERNEL, "occupancy"):
        print(json.dumps(result))
        return 0
    print("== resident blocks an SM, registers, shared and local bytes, by instance")
    scene, cam = cornell_box(), Camera.create()
    n = scene.num_objects
    result["instances"] = {}
    for block in (8, 16):
        rows = {f"K3 {mode}": nk.CUDA_KERNEL.occupancy(mode, block, n) for mode in nk.MODES}
        # the replay that sweeps K1's path tape
        rows["K3 replay taped"] = nk.CUDA_KERNEL.occupancy("replay", block, n, taped=True)
        rows.update(ak.CUDA_KERNEL.instances(block, n))
        # K4's replay that sweeps K1's NEE glossy path tape
        rows["K4 nee_glossy colour taped"] = ak.CUDA_KERNEL.occupancy(True, True, False, block,
                                                                      n, taped=True)
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
    if hasattr(sweep, "lane_pair_shares"):
        print("== collision shares of each inverse cell's first slab: pair bounces whose lanes "
              "add to one slot")
        result["collisions"] = {}
        for cell in ("cornell-nee", "cornell-glossy-nee"):
            got = collision_shares(dev, cell, args.seed)
            result["collisions"][cell] = got
            print(f"  {cell} ({got['rows']} rows): same sphere {got['same']:.4f}, the light "
                  f"{got['light']:.4f}, either {got['either']:.4f}; by bounce, either "
                  f"{got['by_bounce']['either']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
