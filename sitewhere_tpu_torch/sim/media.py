"""Synthetic camera frames — the port's copy of ``sitewhere_tpu/sim/media.py``.

The "naturalistic camera content" the compressed media wire is sized for:
smooth structure plus mild sensor noise, so JPEG quantization leaves a
zigzag spectral extent well under 64 and the coefficient truncation ladder
(``ops/dct.py`` ``COEF_BUCKETS``) bites. The same frames as the
reference's, value for value (numpy only).
"""

from __future__ import annotations

from typing import List

import numpy as np


def camera_frame(size: int, phase: float, seed: int = 5) -> np.ndarray:
    """One uint8[size, size, 3] frame: low-frequency color structure
    (phase-shifted so consecutive frames differ) + sigma-4 sensor noise."""
    rng = np.random.RandomState(seed + int(phase * 1000) % 99991)
    xx, yy = np.meshgrid(np.arange(size), np.arange(size))
    img = np.stack([
        128 + 96 * np.sin(xx / 19 + phase) * np.cos(yy / 23),
        128 + 80 * np.cos(xx / 13 + phase * 1.3),
        128 + 88 * np.sin((xx + yy) / 31 + phase),
    ], -1)
    img = img + rng.randn(size, size, 3) * 4.0
    return np.clip(img, 0, 255).astype(np.uint8)


def camera_frames(size: int, n: int = 8, seed: int = 5) -> List[np.ndarray]:
    """``n`` consecutive frames of the synthetic feed."""
    return [camera_frame(size, i * 0.7, seed) for i in range(n)]
