"""Readings the limits of ``correct`` are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--variant tf32|bf16|half_batch] [--out FILE]

For each seed: one run of the cell (set-up, a window of ``--seconds``, the
check), and one JSON line with the numbers compared, the end-to-end
metrics and the seconds each part took. Without ``--variant`` the numbers
are the program's against the reference (the lower readings); with one,
the reference computed in that variant stands in the program's place (the
control: ``tf32`` where the configuration states f32 with TF32 off,
``bf16`` where it states f32; ``half_batch``: half the batch left out and
the mean taken over the rest), which gives the upper readings. The
benchmark's own runs never run a variant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[:] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + [
    p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()

    import torch

    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False, device,
                                 variant=args.variant)
            line = json.dumps({"workload": args.workload, "seed": seed, "variant": args.variant,
                               "checks": {k: v["value"] for k, v in r["checks"].items()},
                               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                               "attempted": r["attempted"],
                               "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
