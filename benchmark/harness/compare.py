"""The numbers that decide ``correct``: gaps between the program's
readings and the reference's."""

from __future__ import annotations

import statistics
from typing import Iterable, Mapping

import numpy as np

# An element whose reference gradient is under this share of the median
# leaf's root-mean-square gradient is nought to rounding (a key's bias under
# softmax, a third of the packed qkv bias): Adam moves it by round-off
# alone, so it is left out of the change.
NOUGHT = 1e-3


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference, strict=True))


def moving_norms(change: Mapping[str, "torch.Tensor"], ref_grad: Mapping[str, "torch.Tensor"]
                 ) -> dict[str, float]:
    """Each leaf's change norm over its moving elements: those whose
    reference gradient is at least ``NOUGHT`` times the median leaf's
    root-mean-square gradient. Leaves with no such element are left out."""
    rms = statistics.median(float(g.norm()) / g.numel() ** 0.5 for g in ref_grad.values())
    out = {}
    for k, g in ref_grad.items():
        keep = g.abs() >= NOUGHT * rms
        if bool(keep.any()):
            out[k] = float(change[k].to(g.device)[keep].norm())
    return out


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float]) -> dict[str, float]:
    """Each leaf's gap, as :func:`worst_leaf` measures it."""
    floor = statistics.median(reference.values())
    return {k: abs(program[k] - reference[k]) / max(reference[k], floor) for k in reference}


def worst_leaf(program: Mapping[str, float], reference: Mapping[str, float]) -> tuple[float, str]:
    """(gap, leaf) of the worst leaf: the gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf."""
    gaps = leaf_gaps(program, reference)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def unit_gap(program, reference) -> float:
    """The largest L2 distance between two rows of unit vectors (numpy or torch)."""
    p, r = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    return float(np.max(np.linalg.norm(p - r, axis=-1)))

