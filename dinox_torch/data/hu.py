"""Hounsfield-unit decode constants, window ranges and ImageNet normalisation.

16-bit PNGs store ``round(HU) + 32768``; readers decode
``(uint16 - 32768) * 0.1``, so the stack works in deci-HU.
"""

from __future__ import annotations

import numpy as np

HU_SHIFT = 32768
HU_SCALE = 0.1  # deci-HU decode factor

# Random-window augmentation ranges (deci-HU) of the training recipe.
RW_LEVEL_MIN, RW_LEVEL_MAX = -400.0, 400.0
RW_WIDTH_MIN, RW_WIDTH_MAX = 800.0, 2000.0

# Deterministic eval window (deci-HU): L=40, W=400.
EVAL_LEVEL, EVAL_WIDTH = 40.0, 400.0

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
