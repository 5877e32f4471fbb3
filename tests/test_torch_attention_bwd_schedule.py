"""The arithmetic order of the backward tile core
(ops/csrc/attention_bwd_sm90.cuh), emulated in plain PyTorch on the CPU and
held against the JAX package's Pallas kernels in interpret mode: kernel 2
(``_packed_bwd``), its split form kernel 3 (``_packed_bwd_split``, the
ViT-G path) and kernel 5 (``_flash_bwd``). The twin of
test_torch_attention_schedule.py, which does this for the forward core.

The emulation follows the CUDA core step by step:
- the dq kernel: 64-key tiles, the last at the narrowest of 16, 32 or 64
  keys that covers N, keys past N at -inf (TMA zero-fills them). Pass 1:
  s = (q k^T) * scale and dP = dO v^T in f32; the running max m, the sum l
  of exp(s - m) and d = sum exp(s - m) * dP, l and d rescaled by
  exp(m_old - m_new) when m moves; D = d / l. Pass 2: the same tiles again,
  P = exp(s - m) * (1 / l), dS = P (dP - D), dQ += bf16(dS * scale) K in
  f32, tile by tile;
- the dkv kernel: each 64-row query tile in two steps of 32 columns (the
  core's QSTEP, which keeps S^T and dP^T small enough for 3 CTAs per SM),
  the last step at 16 or 32; P^T from the dq kernel's (m, 1 / l, D); query
  columns past N get P = dS = 0; dV += bf16(P^T) dO and
  dK += bf16(dS^T * scale) Q in f32, step by step;
- exp as exp2(x * log2 e), as the core's ex2.
Only the order of the f32 sums inside a product and inside a row differs
from the card. No package code ships the emulation: a change of a rounding
point that would leave the pairs' gate fails here before any card time."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dinox_tpu.ops.flash_attention import _flash_bwd, _packed_bwd, _packed_bwd_split

BLOCK = 64
QSTEP = 32  # query columns per step of the dkv kernel
TAILS = (16, 32, 64)
LOG2E = 1.4426950408889634
REL_TOL = 2e-2  # the pairs' backward gate: 2e-2 of the largest gradient (chip_smoke BWD_REL)
# Largest |emulation - Pallas kernel| / max|Pallas kernel| over each test's
# cases, measured on the CPU and rounded up in the third digit: 1.786e-03
# (kernel 2, N 261 hd 64), 1.613e-03 (kernel 3, N 261 hd 88), 1.623e-03
# (kernel 5, N 261 hd 64), about half a bf16 step of the largest gradient;
# zero for kernels 2 and 3 at N = 37.
MEASURED_MAX = {"kernel 2": 1.79e-3, "kernel 3": 1.62e-3, "kernel 5": 1.63e-3}

CASES = [(n, hd) for n in (37, 261) for hd in (32, 64, 88)]


def steps(n: int, width: int = BLOCK) -> list[tuple[int, int]]:
    """(first row, rows) of each step the core multiplies over an axis of n
    rows in 64-row tiles, at most *width* rows a step."""
    out = []
    for t0 in range(0, n, BLOCK):
        for c0 in range(t0, t0 + BLOCK, width):
            rem = n - c0
            if rem <= 0:
                break
            out.append((c0, width if rem >= width else next(w for w in TAILS if w >= rem)))
    return out


def rows(x: torch.Tensor, r0: int, width: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + width) of x in f32, rows past N zero (TMA's fill)."""
    t = torch.zeros((*x.shape[:-2], width, x.shape[-1]))
    valid = min(width, n - r0)
    t[..., :valid, :] = x[..., r0:r0 + valid, :].float()
    return t


def ex2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x * LOG2E)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_dq(q, k, v, do):
    """The dq kernel on head-major bf16 (B, H, N, hd): dq and each row's
    (m, l, D)."""
    n, hd = q.shape[-2:]
    scale = 1.0 / hd ** 0.5
    qf, dof = q.float(), do.float()
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    d = torch.zeros_like(m)
    tiles = steps(n)

    def logits(k0, width):
        s = torch.matmul(qf, rows(k, k0, width, n).transpose(-1, -2)) * scale
        s[..., min(width, n - k0):] = -torch.inf
        return s, torch.matmul(dof, rows(v, k0, width, n).transpose(-1, -2))

    for k0, width in tiles:  # pass 1
        s, dp = logits(k0, width)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = ex2(m - m_new)
        e = ex2(s - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        d = d * alpha + (e * dp).sum(-1, keepdim=True)
        m = m_new
    dd = d / l
    rinv = 1.0 / l
    dq = torch.zeros(q.shape)
    for k0, width in tiles:  # pass 2
        s, dp = logits(k0, width)
        p = ex2(s - m) * rinv
        dq = dq + torch.matmul(bf16(p * (dp - dd) * scale), rows(k, k0, width, n))
    return dq.to(torch.bfloat16), (m, l, dd)


def emulate_dkv(q, k, v, do, stats):
    """The dkv kernel on head-major bf16 (B, H, N, hd) and the dq kernel's
    (m, l, D): dk and dv."""
    n, hd = q.shape[-2:]
    scale = 1.0 / hd ** 0.5
    m, l, dd = (t.squeeze(-1) for t in stats)
    rinv = 1.0 / l
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    for q0, width in steps(n, QSTEP):
        valid = min(width, n - q0)
        cols = slice(q0, q0 + valid)

        def column_stat(x):  # (..., N) -> (..., 1, width), zero past N
            t = torch.zeros((*x.shape[:-1], width))
            t[..., :valid] = x[..., cols]
            return t.unsqueeze(-2)

        qt, dot = rows(q, q0, width, n), rows(do, q0, width, n)
        st = torch.matmul(kf, qt.transpose(-1, -2)) * scale  # S^T: keys x queries
        dpt = torch.matmul(vf, dot.transpose(-1, -2))
        pt = ex2(st - column_stat(m)) * column_stat(rinv)
        dst = pt * (dpt - column_stat(dd)) * scale
        pt[..., valid:] = 0.0  # query columns past N: P = dS = 0
        dst[..., valid:] = 0.0
        dv = dv + torch.matmul(bf16(pt), dot)
        dk = dk + torch.matmul(bf16(dst), qt)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def emulate(q, k, v, do):
    dq, stats = emulate_dq(q, k, v, do)
    return (dq, *emulate_dkv(q, k, v, do, stats))


def _inputs(n: int, hd: int, seed: int, b: int = 1, heads: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, heads, n, hd)).astype(np.float32) for _ in range(4)]


def _tokens(a: np.ndarray) -> np.ndarray:
    """(B, H, N, hd) -> token-major (B, N, H * hd)."""
    b, h, n, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b, n, h * hd)


def _worst_rel(got: tuple, want: tuple) -> float:
    """Largest error of each gradient over its largest magnitude, worst of
    the three."""
    rels = []
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert np.isfinite(g).all()
        rels.append(np.abs(g - w).max() / np.abs(w).max())
    return max(rels)


def _against_packed(kernel, n: int, hd: int, seed: int) -> float:
    arrays = _inputs(n, hd, seed)
    got = emulate(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))
    qkv = np.concatenate([_tokens(a) for a in arrays[:3]], -1)
    heads = arrays[0].shape[1]
    want = np.asarray(kernel(jnp.asarray(qkv, jnp.bfloat16),
                             jnp.asarray(_tokens(arrays[3]), jnp.bfloat16), heads), np.float32)
    return _worst_rel([_tokens(g.float().numpy()) for g in got], np.split(want, 3, axis=-1))


def test_steps_pad_261_to_272_on_both_axes():
    assert steps(261) == [(0, 64), (64, 64), (128, 64), (192, 64), (256, 16)]
    assert steps(1) == [(0, 16)] and steps(64) == [(0, 64)] and steps(37) == [(0, 64)]
    assert steps(65)[-1] == (64, 16) and steps(90)[-1] == (64, 32)
    assert steps(261, 32)[-2:] == [(224, 32), (256, 16)] and steps(37, 32) == [(0, 32), (32, 16)]
    assert steps(1100)[-1] == (1088, 16)


@pytest.mark.parametrize("n,hd", CASES)
def test_schedule_matches_pallas_kernel_2(n, hd):
    rel = _against_packed(_packed_bwd, n, hd, seed=n + hd)
    assert rel < REL_TOL and rel <= MEASURED_MAX["kernel 2"]


@pytest.mark.parametrize("n", [37, 261])
def test_schedule_matches_pallas_kernel_3(n):
    """The split kernels (dq, then dk + dv), which the JAX package takes at
    ViT-G width (hd 88)."""
    rel = _against_packed(_packed_bwd_split, n, 88, seed=3 * n)
    assert rel < REL_TOL and rel <= MEASURED_MAX["kernel 3"]


def test_schedule_matches_pallas_at_n_1100():
    """N = 1100 through ``_packed_bwd`` itself: at two heads its stack check
    (two f32 (N, N) blocks per head past 12 MiB) sends the call to the split
    kernels, kernel 3, so this case holds the emulation against kernel 3 at
    an N of 18 query and key tiles with a 16-row tail."""
    rel = _against_packed(_packed_bwd, 1100, 64, seed=1100)
    assert rel < REL_TOL and rel <= MEASURED_MAX["kernel 3"]


@pytest.mark.parametrize("n,hd", CASES)
def test_schedule_matches_pallas_kernel_5(n, hd):
    arrays = _inputs(n, hd, seed=2 * n + hd)
    got = emulate(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))
    want = _flash_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    rel = _worst_rel([g.float().numpy() for g in got], want)
    assert rel < REL_TOL and rel <= MEASURED_MAX["kernel 5"]


def test_dkv_masks_query_columns_past_n():
    """Zero-filled statistics past N (m = l = 0) would give exp(s) * inf and,
    against the zero dO rows, NaN in dV: the columns must be masked, not
    left to the data."""
    arrays = _inputs(37, 64, seed=5)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    dq, stats = emulate_dq(q, k, v, do)
    dk, dv = emulate_dkv(q, k, v, do, stats)
    assert torch.isfinite(dk.float()).all() and torch.isfinite(dv.float()).all()
    from dinox_torch.ops.flash_attention import mha_attention_backward_reference
    want = mha_attention_backward_reference(q, k, v, do)
    assert _worst_rel([t.float().numpy() for t in (dq, dk, dv)],
                      [t.float().numpy() for t in want]) < REL_TOL
