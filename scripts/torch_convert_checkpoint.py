"""Carry a denoiser trained by the JAX package across to the PyTorch port.

Reads an orbax checkpoint directory of ``pathtrace_tpu.train`` (its
``model.json`` and the ``--name`` snapshot) and writes the port's layout into
the output directory: the same ``model.json`` and ``<name>.pt``
(``pathtrace_tpu_torch.train.save_checkpoint``) with the whole trainer
state: weights, BN statistics, the SGD momentum buffers and the plateau
fields, through ``pathtrace_tpu_torch.convert.train_state_from_flax``. So
``python -m pathtrace_tpu_torch.train --resume DST_DIR`` continues the JAX
run where it stopped, and ``-d --checkpoint DST_DIR`` denoises with it.

This script imports JAX, so it runs where the JAX package does; the port
itself never imports JAX. Usage, from the root of a checkout:

    python scripts/torch_convert_checkpoint.py SRC_DIR DST_DIR [--name model_epoch]

"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src_dir: str, dst_dir: str, name: str = "model_epoch") -> str:
    """Convert one snapshot -> the path of the written ``<name>.pt``."""
    import jax
    import numpy as np

    from pathtrace_tpu.train import load_checkpoint as load_orbax
    from pathtrace_tpu_torch.convert import train_state_from_flax
    from pathtrace_tpu_torch.models.denoise_cnn import DenoiseCNN
    from pathtrace_tpu_torch.train import create_state, save_checkpoint

    model, state = load_orbax(src_dir, name=name)
    tree = jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "trace": state.opt_state.inner_state[0].trace, "lr": state.lr,
        "best_loss": state.best_loss, "plateau_count": state.plateau_count,
        "epoch": state.epoch})
    port = create_state(DenoiseCNN(model.widths, model.lateral_features), device="cpu")
    port.load_state_dict(train_state_from_flax(tree))
    return save_checkpoint(dst_dir, port, name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="orbax checkpoint directory of pathtrace_tpu.train")
    p.add_argument("dst", help="output directory for the port's checkpoint")
    p.add_argument("--name", default="model_epoch", help="snapshot: model_epoch or model_best")
    args = p.parse_args(argv)
    print(convert(args.src, args.dst, args.name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
