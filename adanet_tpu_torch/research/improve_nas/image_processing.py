"""CIFAR image augmentation: pad-and-crop, horizontal flip, cutout.

Copy of research/improve_nas/trainer/image_processing.py (imports
renamed; `tests/test_torch_port_rules.py` keeps it in sync). Randomness
(offsets) is sampled in numpy; the per-pixel transform runs in the
native C++ library (`adanet_tpu_torch/ops/csrc/augment.cc` via
`adanet_tpu_torch.ops.native_augment`) when it builds, with a numpy
implementation as the exact oracle and fallback. Augmentation is host
work: the card only ever sees augmented batches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from adanet_tpu_torch.ops import native_augment


def sample_offsets(
    n: int,
    h: int,
    w: int,
    rng: np.random.RandomState,
    pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-image crop offsets, flip flags, and cutout centers."""
    tops = rng.randint(0, 2 * pad + 1, size=n).astype(np.int32)
    lefts = rng.randint(0, 2 * pad + 1, size=n).astype(np.int32)
    flips = (rng.rand(n) < 0.5).astype(np.uint8)
    cut_ys = rng.randint(0, h, size=n).astype(np.int32)
    cut_xs = rng.randint(0, w, size=n).astype(np.int32)
    return tops, lefts, flips, cut_ys, cut_xs


def apply_numpy(
    images: np.ndarray,
    tops: np.ndarray,
    lefts: np.ndarray,
    flips: np.ndarray,
    cut_ys: np.ndarray,
    cut_xs: np.ndarray,
    pad: int,
    cutout: int,
) -> np.ndarray:
    """Reference (oracle) implementation of the deterministic transform."""
    n, h, w, _ = images.shape
    padded = np.pad(
        images, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant"
    )
    out = np.empty_like(images)
    for i in range(n):
        img = padded[i, tops[i] : tops[i] + h, lefts[i] : lefts[i] + w, :]
        if flips[i]:
            img = img[:, ::-1, :]
        out[i] = img
        if cutout > 0:
            y0 = max(0, int(cut_ys[i]) - cutout // 2)
            y1 = min(h, int(cut_ys[i]) + cutout // 2)
            x0 = max(0, int(cut_xs[i]) - cutout // 2)
            x1 = min(w, int(cut_xs[i]) + cutout // 2)
            out[i, y0:y1, x0:x1, :] = 0.0
    return out


def augment_batch(
    images: np.ndarray,
    rng: np.random.RandomState,
    pad: int = 4,
    cutout_size: int = 16,
    use_cutout: bool = True,
    backend: str = "auto",
) -> np.ndarray:
    """Random crop (after padding), random flip, and cutout per image.

    backend: "auto" (native C++ when buildable, else numpy), "native", or
    "numpy". Both backends are bit-identical for the same offsets.
    """
    n, h, w, _ = images.shape
    cutout = cutout_size if use_cutout else 0
    tops, lefts, flips, cut_ys, cut_xs = sample_offsets(n, h, w, rng, pad)
    if backend in ("auto", "native"):
        out = native_augment.augment_apply(
            images, tops, lefts, flips, cut_ys, cut_xs, pad, cutout
        )
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("Native augmentation library unavailable.")
    return apply_numpy(
        images, tops, lefts, flips, cut_ys, cut_xs, pad, cutout
    )
