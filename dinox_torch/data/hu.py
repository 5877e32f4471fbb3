"""Hounsfield-unit decode constants and ImageNet normalisation.

16-bit PNGs store ``round(HU) + 32768``; readers decode
``(uint16 - 32768) * 0.1``, so the stack works in deci-HU.
"""

from __future__ import annotations

import numpy as np

HU_SHIFT = 32768
HU_SCALE = 0.1  # deci-HU decode factor

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
