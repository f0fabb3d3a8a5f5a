"""What the main paths' entry points give and cost on the card, for one tree:
the outputs at fixed inputs, and the inverse steps' time beside the device's.

    python scripts/torch_launch_path.py [--root DIR] [--label NAME] [--steps 20] [--out DIR]
    python scripts/torch_launch_path.py --compare A.npz B.npz

Needs one CUDA device. With scene and camera on the host, as the CLI and the
inverse demo hold them:

1. Outputs: every entry point of ``chip_smoke.main_path_calls`` once at its
   sizes (the bench's 512x512x32 frame, the inverse steps' 256x256), and
   each inverse ``step_fn`` for 10 steps from its start (diffuse albedos,
   NEE position and radius, glossy albedos and positions), written to
   ``<out>/launch_path_<label>.npz`` (``--out``, default ``chiprun_out``;
   ~90 MB).
2. Times of the three inverse steps (diffuse 256x256x8, NEE 256x256x16,
   glossy 256x256x8): CUDA events around one step at a time (median of
   ``--steps``, as chip_smoke.py times a step), and around ``--steps`` steps
   enqueued back to back (ms a step); ``torch.profiler``'s device time a
   step; the device's idle share of a step, 1 - device / step, for each;
   written to ``<out>/launch_path_<label>.json``.

``--root DIR`` runs the package of another checkout (a ``git archive`` of
another commit) with this script and this tree's ``chip_smoke.py``. To
compare two trees, run one process each in one call on the chip, then
``--compare`` their files: the largest |difference| of each output, whether
it is 0, and each output's largest change relative to its largest value.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
ROOT = (Path(sys.argv[sys.argv.index("--root") + 1]).resolve() if "--root" in sys.argv
        else HERE)
sys.path.insert(0, str(ROOT))

INVERSE_OUTPUT_STEPS = 10


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(prefix, x, out):
    """The tensors of an entry point's result as numpy arrays under dotted
    names."""
    import torch

    if torch.is_tensor(x):
        out[prefix] = x.detach().cpu().numpy()
    elif isinstance(x, dict):
        for k, v in x.items():
            _flat(f"{prefix}.{k}", v, out)
    elif isinstance(x, (tuple, list)):
        for k, v in enumerate(x):
            _flat(f"{prefix}.{k}", v, out)
    else:
        for k in ("radius", "position", "emission", "color", "yaw", "pitch"):
            if hasattr(x, k):
                _flat(f"{prefix}.{k}", getattr(x, k), out)


def compare(a_path, b_path) -> int:
    a, b = np.load(a_path), np.load(b_path)
    if sorted(a.files) != sorted(b.files):
        print(f"the files hold other outputs: {sorted(set(a.files) ^ set(b.files))}")
        return 1
    worst = {}
    for k in sorted(a.files):
        d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
        top = float(np.abs(b[k]).max()) if b[k].size else 0.0
        diff = float(d.max()) if d.size else 0.0
        worst[k] = (diff, diff / top if top > 0 else 0.0)
        print(f"  {k:60s} max |diff| {diff:.3e}  relative {worst[k][1]:.3e}  "
              f"{'bits equal' if diff == 0 else 'DIFFERS'}")
    differ = [k for k, (d, _) in worst.items() if d != 0]
    print(f"{len(worst)} outputs, {len(worst) - len(differ)} equal to the bit; differing: "
          f"{differ}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="the checkout whose package runs (default: this one)")
    ap.add_argument("--label", default="this")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=str(HERE / "chiprun_out"))
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)

    import torch

    if not torch.cuda.is_available():
        print("torch_launch_path: no CUDA device", file=sys.stderr)
        return 1
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, inverse
    from pathtrace_tpu_torch.utils.timing import device_name, time_fn

    cs = _load_chip_smoke()
    dev = torch.device("cuda", 0)
    print(f"[{args.label}] card: {device_name(dev)}; package of {ROOT}")
    scene, cam = cornell_box(), Camera.create()

    outputs = {}
    for name, call in cs.main_path_calls(dev, scene, cam):
        if name.startswith("inverse"):
            continue
        _flat(name, call(), outputs)
    gen = torch.Generator(device=dev).manual_seed(14)
    target = torch.rand((256, 256, 3), generator=gen, device=dev)
    routes = {"diffuse": ({}, ("color",), 2e-2),
              "nee": ({"nee": True}, ("position", "radius"), {"position": 0.5, "radius": 0.1}),
              "glossy": ({"brdf": "glossy"}, ("color", "position"),
                         {"color": 2e-2, "position": 0.5})}
    steps = {}
    for r, (extra, fields, rate) in routes.items():
        cfg = RenderConfig(width=256, height=256, spp=16 if r == "nee" else 8, **extra)
        state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, fields, rate,
                                                      device=dev)
        steps[r] = (step_fn, state)
        for _ in range(INVERSE_OUTPUT_STEPS):
            state, loss = step_fn(state)
        _flat(f"inverse step_fn [{r}] x{INVERSE_OUTPUT_STEPS}", (state.params, loss), outputs)
    torch.cuda.synchronize()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / f"launch_path_{args.label}.npz", **outputs)
    print(f"[{args.label}] {len(outputs)} outputs written to "
          f"{out_dir / f'launch_path_{args.label}.npz'}")

    record = {"label": args.label, "card": device_name(dev), "steps": {}}
    for r, (step_fn, state) in steps.items():
        held = [state]

        def one():
            held[0], loss = step_fn(held[0])
            return loss

        ms, _ = time_fn(one, warmup=3, iters=args.steps, device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.steps):
            one()
        end.record()
        end.synchronize()
        back_to_back = start.elapsed_time(end) / args.steps
        device_ms, _ = cs.profile_steps(f"[{args.label}] {r}", step_fn, held[0],
                                        statistics.median(ms), steps=args.steps)
        rec = dict(step_ms=statistics.median(ms), step_ms_min=min(ms), step_ms_max=max(ms),
                   back_to_back_ms=back_to_back, device_ms=device_ms,
                   idle=1.0 - device_ms / statistics.median(ms),
                   idle_back_to_back=1.0 - device_ms / back_to_back)
        record["steps"][r] = rec
        print(f"[{args.label}] inverse step {r}: {rec['step_ms']:.4f} ms a step alone (runs "
              f"{rec['step_ms_min']:.4f}..{rec['step_ms_max']:.4f}), {back_to_back:.4f} ms a "
              f"step back to back; device {device_ms:.4f} ms; idle {rec['idle']:.3f} alone, "
              f"{rec['idle_back_to_back']:.3f} back to back")
    (out_dir / f"launch_path_{args.label}.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
