"""Hounsfield-unit storage, decode constants, window ranges and ImageNet
normalisation: the port's copy of ``dinox_tpu.data.hu``.

16-bit PNGs store ``round(HU) + 32768`` (:func:`encode_hu16`); readers
decode ``(uint16 - 32768) * 0.1`` (:func:`decode_hu16`), so the stack works
in deci-HU.
"""

from __future__ import annotations

import numpy as np

HU_SHIFT = 32768
HU_SCALE = 0.1  # deci-HU decode factor
HU_CLIP = (-1000.0, 4000.0)  # the preprocessing CLIs' clip of true HU before encoding

# Random-window augmentation ranges (deci-HU) of the training recipe.
RW_LEVEL_MIN, RW_LEVEL_MAX = -400.0, 400.0
RW_WIDTH_MIN, RW_WIDTH_MAX = 800.0, 2000.0

# Deterministic eval window (deci-HU): L=40, W=400.
EVAL_LEVEL, EVAL_WIDTH = 40.0, 400.0

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def encode_hu16(hu: np.ndarray) -> np.ndarray:
    """True HU float -> storable uint16 (writer side; clips to the encodable range)."""
    return np.clip(np.round(hu) + HU_SHIFT, 0, 65535).astype(np.uint16)


def decode_hu16(arr: np.ndarray) -> np.ndarray:
    """Stored uint16 (or float thereof) -> deci-HU float32."""
    return (arr.astype(np.float32) - HU_SHIFT) * HU_SCALE


def window(hu: np.ndarray, level: float, width: float) -> np.ndarray:
    """Map a (deci-)HU array into [0, 1] with centre *level* and width *width*:
    ``clip((hu - (level - width/2)) / max(width, 1), 0, 1)``."""
    lo = level - width / 2.0
    out = (hu - lo) / max(width, 1.0)
    return np.clip(out, 0.0, 1.0)
