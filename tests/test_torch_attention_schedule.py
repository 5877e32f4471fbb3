"""The arithmetic order of the forward tile core (ops/csrc/attention_fwd_sm90.cuh),
emulated in plain PyTorch on the CPU and held against the JAX package's
Pallas kernels in interpret mode: kernel 1 (``_packed_fwd``, what
``flash_attention_packed`` runs for N <= 1024; called directly so N = 1100
reaches the kernel too) and kernel 4 (``_flash_fwd``).

The emulation follows the CUDA core step by step:
- 64-key tiles, the last one at the narrowest of 16, 32 or 64 keys that
  covers N, its keys past N masked to -inf (TMA zero-fills them);
- exp as exp2((s - m) * log2 e), normalisation as a product with 1 / l;
- kernel 1 (Rounding::Packed): q * scale rounded to bf16; one pass with an
  online softmax: per tile the running max m, the sum l and the f32 O
  rescaled by exp2((m_old - m_new) * log2 e); the unnormalised P rounded to
  bf16 before PV; O * (1 / l) at the end;
- kernel 4 (Rounding::Normalised): s * scale in f32; pass 1 over the same
  tiles for m and l (online); pass 2 P = bf16(exp2((s - m) * log2 e) * (1 / l)).
Only the order of the f32 sums inside a product differs from the card. No
package code ships the emulation: a rounding change that would leave the
kernels' 0.02 gate fails here before any card time."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dinox_tpu.ops.flash_attention import _flash_fwd, _packed_fwd

BLOCK = 64
TAILS = (16, 32, 64)
LOG2E = 1.4426950408889634
TOL = 0.02  # the kernels' bf16 forward gate (bench.py --check)
# Largest |emulation - Pallas kernel| over the cases below, measured on the
# CPU: 2^-9 = 1.953e-03 for kernel 1 (one bf16 step at |o| in [0.25, 0.5))
# and 2^-10 = 9.766e-04 for kernel 4; zero at N = 37 (one tile).
MEASURED_MAX = {"packed": 2.0 ** -9, "normalised": 2.0 ** -10}

CASES = [(n, hd) for n in (37, 261, 1100) for hd in (32, 64, 88)]


def key_tiles(n: int) -> list[tuple[int, int]]:
    """(first key, width) of each tile the core multiplies."""
    tiles = []
    for k0 in range(0, n, BLOCK):
        rem = n - k0
        tiles.append((k0, BLOCK if rem >= BLOCK else next(w for w in TAILS if w >= rem)))
    return tiles


def tile_logits(q: torch.Tensor, k: torch.Tensor, k0: int, width: int, n: int) -> torch.Tensor:
    """f32 Q K^T over keys [k0, k0 + width), keys past N at -inf."""
    kt = torch.zeros((*k.shape[:-2], width, k.shape[-1]))
    valid = min(width, n - k0)
    kt[..., :valid, :] = k[..., k0:k0 + valid, :].float()
    s = torch.matmul(q.float(), kt.transpose(-1, -2))
    s[..., valid:] = -torch.inf
    return s


def tile_values(v: torch.Tensor, k0: int, width: int, n: int) -> torch.Tensor:
    vt = torch.zeros((*v.shape[:-2], width, v.shape[-1]))
    valid = min(width, n - k0)
    vt[..., :valid, :] = v[..., k0:k0 + valid, :].float()
    return vt


def ex2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x * LOG2E)


def emulate_packed(q, k, v):
    """Kernel 1's order on head-major bf16 (B, H, N, hd) q, k, v."""
    n, hd = q.shape[-2:]
    qs = (q.float() * (1.0 / hd ** 0.5)).to(torch.bfloat16)
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0, width in key_tiles(n):
        s = tile_logits(qs, k, k0, width, n)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = ex2(m - m_new)
        p = ex2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(torch.bfloat16).float(), tile_values(v, k0, width, n))
        m = m_new
    return (o * (1.0 / l)).to(torch.bfloat16)


def emulate_normalised(q, k, v):
    """Kernel 4's order on head-major bf16 (B, H, N, hd) q, k, v."""
    n, hd = q.shape[-2:]
    scale = 1.0 / hd ** 0.5
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for k0, width in key_tiles(n):  # pass 1
        s = tile_logits(q, k, k0, width, n) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * ex2(m - m_new) + ex2(s - m_new).sum(-1, keepdim=True)
        m = m_new
    rinv = 1.0 / l
    o = torch.zeros(q.shape)
    for k0, width in key_tiles(n):  # pass 2
        p = ex2(tile_logits(q, k, k0, width, n) * scale - m) * rinv
        o = o + torch.matmul(p.to(torch.bfloat16).float(), tile_values(v, k0, width, n))
    return o.to(torch.bfloat16)


def _inputs(n: int, hd: int, seed: int, b: int = 1, heads: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, heads, n, hd)).astype(np.float32) for _ in range(3)]


def test_key_tiles_pad_261_to_272():
    assert key_tiles(261) == [(0, 64), (64, 64), (128, 64), (192, 64), (256, 16)]
    assert [w for _, w in key_tiles(1100)][-1] == 16 and key_tiles(37) == [(0, 64)]
    assert key_tiles(1) == [(0, 16)] and key_tiles(64) == [(0, 64)]
    assert key_tiles(65)[-1] == (64, 16) and key_tiles(90)[-1] == (64, 32)


@pytest.mark.parametrize("n,hd", CASES)
def test_packed_schedule_matches_pallas_kernel_1(n, hd):
    arrays = _inputs(n, hd, seed=n + hd)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = emulate_packed(q, k, v)
    b, heads = q.shape[:2]
    # The same data packed as (B, N, 3 * dim) [q|k|v] rows.
    qkv = np.concatenate([a.transpose(0, 2, 1, 3).reshape(b, n, heads * hd) for a in arrays], -1)
    want = np.asarray(_packed_fwd(jnp.asarray(qkv, jnp.bfloat16), heads), np.float32)
    got_tokens = got.float().transpose(1, 2).reshape(b, n, heads * hd).numpy()
    err = np.abs(got_tokens - want).max()
    assert np.isfinite(got_tokens).all() and err < TOL
    assert err <= MEASURED_MAX["packed"]


@pytest.mark.parametrize("n,hd", CASES)
def test_normalised_schedule_matches_pallas_kernel_4(n, hd):
    arrays = _inputs(n, hd, seed=2 * n + hd)
    got = emulate_normalised(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))
    want = np.asarray(_flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in arrays)), np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert np.isfinite(got.float().numpy()).all() and err < TOL
    assert err <= MEASURED_MAX["normalised"]
