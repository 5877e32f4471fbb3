"""The arithmetic order of the port's kernel 6 (ops/csrc/fused_attn_block.cu
on the GEMM core ops/csrc/gemm_sm90.cuh and kernel 1's forward core),
emulated in plain PyTorch on the CPU and held against the JAX package's
Pallas kernel ``_call_fused`` in interpret mode.

The emulation follows the three launches step by step:
1. LN + QKV over the flattened B*N rows in 64-row blocks, rows past B*N
   zero (TMA zero-fills them; LN makes them beta, and they are never
   stored): each row's f32 sum and sum of squares, mean and fast variance
   divided by dim, ln = bf16(((x - mu) * rstd) * gamma + beta) in place;
   then the f32 accumulator over 16-deep K steps (one wgmma k16 each), the
   f32 bias added to it and one rounding;
2. attention through ``emulate_packed`` of test_torch_attention_schedule.py
   (kernel 1's order, which launch 2 runs);
3. proj: the same K-step accumulation over attn, then bf16(x32 + (acc +
   bproj)).
Only the order of the f32 sums inside a k16 step and inside a row's
statistics differs from the card. No package code ships the emulation: a
rounding change that would leave the kernel's 0.05 gate fails here before
any card time."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dinox_tpu.ops import fused_attn_block as jax_fab
from tests.test_torch_attention_schedule import emulate_packed

BLOCK_M, K_STEP = 64, 16
LN_EPS = 1e-5
TOL = 3e-2  # the bf16 bound of test_torch_fused_attn_block.py (the JAX package's bf16 test bound)
# Largest |emulation - Pallas kernel| over the cases below and the three
# outputs, measured on the CPU: 2^-6 = 1.5625e-02 in qkv (one bf16 step at
# |qkv| in [2, 4), in at most 0.2% of its elements); y 2^-7, attn 2^-8.
MEASURED_MAX = 2.0 ** -6

# (b, n, dim, heads): two ViT-S views, hd 32 at dim 512, hd 88 at ViT-G's
# dim 1408 on one view, and B*N = 111, not a multiple of 64.
CASES = [(2, 261, 384, 6), (1, 261, 512, 16), (1, 261, 1408, 16), (3, 37, 384, 6)]


def k_steps(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 a @ w^T (w in the (out, in) layout) summed over 16-deep K steps."""
    acc = torch.zeros((a.shape[0], w.shape[0]))
    for k0 in range(0, a.shape[1], K_STEP):
        acc = acc + a[:, k0:k0 + K_STEP].float() @ w[:, k0:k0 + K_STEP].float().t()
    return acc


def row_blocks(t: torch.Tensor) -> torch.Tensor:
    """(rows, width) zero-padded to whole 64-row blocks."""
    pad = -t.shape[0] % BLOCK_M
    return torch.cat([t, t.new_zeros((pad, t.shape[1]))])


def emulate_fused(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads):
    """Kernel 6's order on bf16 x (B, N, dim) and bf16 (out, in) weights;
    returns (y, qkv, attn) in bf16."""
    b, n, dim = x.shape
    rows = b * n
    bf16 = torch.bfloat16
    x32 = row_blocks(x.reshape(rows, dim)).float()
    mu = x32.sum(-1, keepdim=True) / dim
    rstd = torch.rsqrt(((x32 * x32).sum(-1, keepdim=True) / dim - mu * mu).clamp_min(0.0) + LN_EPS)
    ln = ((x32 - mu) * rstd * gamma + beta).to(bf16)
    qkv = (k_steps(ln, wqkv) + bqkv).to(bf16)[:rows].view(b, n, 3 * dim)
    hd = dim // heads
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    attn = emulate_packed(q, k, v).transpose(1, 2).reshape(b, n, dim)
    a = row_blocks(attn.reshape(rows, dim))
    y = (x32 + (k_steps(a, wproj) + bproj)).to(bf16)[:rows].view(b, n, dim)
    return y, qkv, attn


def _inputs(b, n, dim, seed):
    """numpy inputs at the JAX check's scales (dinox_torch.bench
    .fused_block_inputs): x and the weights rounded to bf16 first, so both
    sides see the same values; weights in the (out, in) layout."""
    rng = np.random.default_rng(seed)
    ws = 0.05 * (384 / dim) ** 0.5
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (bf(rng.normal(size=(b, n, dim)) * 0.5), f32(1 + 0.1 * rng.normal(size=dim)),
            f32(0.1 * rng.normal(size=dim)), bf(rng.normal(size=(3 * dim, dim)) * ws),
            f32(0.02 * rng.normal(size=3 * dim)), bf(rng.normal(size=(dim, dim)) * ws),
            f32(0.02 * rng.normal(size=dim)))


def test_row_blocks_pad_to_64():
    assert row_blocks(torch.ones(111, 8)).shape == (128, 8)
    assert row_blocks(torch.ones(64, 8)).shape == (64, 8)
    assert row_blocks(torch.ones(1, 8))[1:].abs().sum() == 0


@pytest.mark.parametrize("b,n,dim,heads", CASES)
def test_fused_schedule_matches_pallas_kernel_6(b, n, dim, heads, monkeypatch):
    """y, qkv and attn of the emulation against the Pallas kernel's. The
    Pallas wrapper sizes its batch group for the TPU's VMEM and takes no
    group at dim 1408 (its weights alone pass the budget); interpret mode
    on the CPU has no VMEM, so the group is set to 1, which changes no
    arithmetic (each view is computed alone)."""
    monkeypatch.setattr(jax_fab, "_pick_group", lambda *a: 1)
    args = _inputs(b, n, dim, seed=b * n + dim)
    got = emulate_fused(*args, heads)
    x, gamma, beta, wqkv, bqkv, wproj, bproj = args
    jx = [jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(gamma.numpy()),
          jnp.asarray(beta.numpy()), jnp.asarray(wqkv.float().t().numpy(), jnp.bfloat16),
          jnp.asarray(bqkv.numpy()), jnp.asarray(wproj.float().t().numpy(), jnp.bfloat16),
          jnp.asarray(bproj.numpy())]
    want = jax_fab._call_fused(*jx, heads)
    for name, g, w in zip(("y", "qkv", "attn"), got, want):
        g = g.float().numpy()
        err = np.abs(g - np.asarray(w, np.float32)).max()
        assert np.isfinite(g).all() and g.shape == w.shape, name
        assert err < TOL, (name, err)
        assert err <= MEASURED_MAX, (name, err)
