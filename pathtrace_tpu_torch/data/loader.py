"""EXR-file dataset loading — the reference's offline interop path.

The counterpart of ``pathtrace_tpu.data.loader``. The primary pipeline
renders training pairs in-process (``data/collect.py``); this module is the
equivalent of ``denoise_cnn/load_data.py``/``data.py`` for datasets that
live on disk as EXR files (including files produced by the original CUDA
renderer, whose channel layout ``io/exr.py`` reads).

``load_exr_training_pair`` mirrors ``load_exr_data(preprocess=True,
concat=True)`` + ``target=True`` (``load_data.py:7-40``) in the
channels-last layout; ``get_dataset_from_dir`` mirrors ``data.get_dataset``
(``data.py:5-30``: {i}_train.exr / {i}_gt.exr pairs, patch extraction with
variance-importance sampling, pair 0 as the test split). All of it is host
work: arrays in, numpy arrays out.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from pathtrace_tpu_torch.data.patches import get_patches
from pathtrace_tpu_torch.io.exr import load_aovs_exr
from pathtrace_tpu_torch.models.preprocess import preprocess_channels, preprocess_target
from pathtrace_tpu_torch.render import pack_channels


def load_exr_channels(path) -> np.ndarray:
    """An AOV EXR -> packed [H, W, 14] buffer (raw, unpreprocessed)."""
    aovs = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in load_aovs_exr(path).items()}
    return pack_channels(aovs).numpy()


def load_exr_training_pair(train_path, gt_path) -> Tuple[np.ndarray, np.ndarray]:
    """(preprocessed input [H, W, 14], clipped target color [H, W, 3])."""
    x = preprocess_channels(torch.from_numpy(load_exr_channels(train_path)))
    y = preprocess_target(torch.from_numpy(load_exr_channels(gt_path)))
    return x.numpy(), y.numpy()


def get_dataset_from_dir(
    data_dir: str,
    n_pairs: Optional[int] = None,
    patch_size: int = 256,
    patches_per_image: int = 16,
    seed: int = 0,
):
    """Assemble (train_inputs, train_targets, test_input, test_target) from
    ``{i}_train.exr`` / ``{i}_gt.exr`` pairs, as ``data.get_dataset`` did
    (33 pairs x 16 patches of 256^2; pair 0 full-frame as the test split,
    ``data.py:9-29``)."""
    if n_pairs is None:
        n_pairs = 0
        while os.path.exists(os.path.join(data_dir, f"{n_pairs}_train.exr")):
            n_pairs += 1
    if n_pairs == 0:
        raise FileNotFoundError(f"no 0_train.exr in {data_dir}")
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i in range(n_pairs):
        x, y = load_exr_training_pair(
            os.path.join(data_dir, f"{i}_train.exr"),
            os.path.join(data_dir, f"{i}_gt.exr"),
        )
        px, py = get_patches(x, y, patch_size, patches_per_image, rng=rng)
        xs.append(px)
        ys.append(py)
    test_x, test_y = load_exr_training_pair(
        os.path.join(data_dir, "0_train.exr"),
        os.path.join(data_dir, "0_gt.exr"),
    )
    return (
        np.concatenate(xs),
        np.concatenate(ys),
        test_x[None],
        test_y[None],
    )
