"""The arithmetic order of the port's kernels 7 and 8 (ops/csrc/fused_mlp.cu
and ops/csrc/fused_mlp_bwd.cu on the GEMM cores of ops/csrc/gemm_sm90.cuh),
emulated in plain PyTorch on the CPU and held against the JAX package's
Pallas kernels ``_fwd`` and ``_bwd`` in interpret mode.

Kernel 7, launch by launch:
1. fc1: each row's two-pass f32 statistics (mean, then mean((x - mu)^2)
   over the width), ln = bf16(((x - mu) * rstd) * gamma + beta) in place;
   the f32 accumulator over 16-deep K steps (one wgmma k16 each); b1 added
   to it, then the exact GELU, then one rounding: a;
2. fc2: the same K steps over hidden (a's tiles streamed), then
   bf16(x32 + (acc + b2)).
Kernel 8:
1. norm: lnb as in fc1;
2. hidden: h = lnb W1^T + b1 and da = dyb W2 over 16-deep K steps;
   p = (1 + erf(h / sqrt 2)) / 2, ab = bf16(h p), dh = da (p + h phi(h)),
   erf from the TPU kernel's polynomial (as in fc1's GELU),
   dhb = bf16(dh); each 64-row block's column sums of dh in the epilogue's
   order (a lane's rows r and r + 8, a butterfly over the warp's eight
   row pairs, then warps 0-3 in order);
3. dln = dhb W1 (f32, K steps over hidden);
4. dx: the statistics again, dx = bf16(dy + rstd (dxh - mean(dxh) -
   xhat mean(dxh xhat))), and each 64-row block's column sums of dln xhat,
   dln and dy, each warp over rows w, w + 8, ... in order, then warps 0-7
   in order;
5. weights: dW2 = dyb^T ab and dW1 = dhb^T lnb per row chunk (a multiple of
   64 rows) over 16-row K steps;
6. reduce: the chunks in order; the row blocks' partials in eight
   interleaved runs (run g: blocks g, g + 8, ...), the runs in order.
Only the order of the f32 sums inside a k16 step and inside a lane's row
statistics differs from the card. No package code ships the emulation: a
rounding or order change that would leave the kernels' gates fails here
before any card time.

Tolerances. Both sides round ln, a, ab, dhb and y (dx) to bf16 at the same
points and take erf from the same polynomial, but the Pallas kernels sum
each product in one f32 dot, so a value near a bf16 rounding
boundary may round the other way: y and dx are held within 3e-2 (the JAX
package's bf16 bound; one bf16 step at |y| in [2, 4) is 1.6e-2), each f32
gradient within 2e-2 of its largest value (the card gate). The measured
largest differences stand beside them.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dinox_tpu.ops import fused_mlp as jax_fm

K_STEP, BLOCK, LN_EPS = 16, 64, 1e-5
SQRT_HALF, INV_SQRT_2PI = 0.7071067811865476, 0.3989422804014327
Y_TOL, REL_TOL = 3e-2, 2e-2
# Largest differences measured on the CPU over the cases below: y 2^-8, dx
# 2^-6 (one bf16 step at |dx| in [2, 4)), the f32 gradients 4.4e-4 of their
# largest value (dw2 at 384 -> 1536).
MEASURED_Y, MEASURED_DX, MEASURED_REL = 2.0 ** -8, 2.0 ** -6, 5e-4

# (rows, C, hidden, rows per weight chunk): a row count that is not a
# multiple of 64 with a chunk of 64 rows (two chunks), one short ViT-S view
# (261 rows at 384 -> 1536) in one chunk, a narrow width, and more rows
# than a chunk (200 rows in chunks of 64: four chunks, the last ragged).
CASES = [(74, 64, 256, 64), (261, 384, 1536, 320), (40, 32, 128, 64), (200, 64, 256, 64)]


def k_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 a @ b (a (M, K), b (K, N)) summed over 16-deep K steps."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], K_STEP):
        acc = acc + a[:, k0:k0 + K_STEP].float() @ b[k0:k0 + K_STEP].float()
    return acc


def ln_two_pass(x32: torch.Tensor, gamma, beta):
    """(ln in f32, xhat, rstd) with the two-pass variance, sums divided by C."""
    c = x32.shape[1]
    mu = x32.sum(-1, keepdim=True) / c
    rstd = torch.rsqrt(((x32 - mu) ** 2).sum(-1, keepdim=True) / c + LN_EPS)
    xhat = (x32 - mu) * rstd
    return xhat * gamma + beta, xhat, rstd


def gelu_parts(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gelu(h), gelu'(h)) as the epilogues form them (gemm_sm90.cuh
    gelu_p): erf from the TPU kernel's polynomial, whose exp(-x^2) at x =
    |h| / sqrt 2 is also GELU''s Gaussian factor; p once, then h p and
    p + h e / sqrt(2 pi)."""
    ax = h.abs() * SQRT_HALF
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t - 0.284496736) * t
            + 0.254829592) * t
    e = torch.exp(-ax * ax)
    p = 0.5 * (1.0 + torch.copysign(1.0 - poly * e, h))
    return h * p, p + h * e * INV_SQRT_2PI


def emulate_forward(x, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Kernel 7 on bf16 rows x (M, C) and bf16 (out, in) weights."""
    bf16 = torch.bfloat16
    x32 = x.float()
    ln = ln_two_pass(x32, gamma, beta)[0].to(bf16)
    a = gelu_parts(k_steps(ln, w1.t()) + b1)[0].to(bf16)
    return (x32 + (k_steps(a, w2.t()) + b2)).to(bf16)


def block_sums_hidden(d: torch.Tensor) -> torch.Tensor:
    """Column sums of a 64-row block (rows past M zero) in the hidden
    epilogue's order: row = 16 warp + 8 r + g; a lane adds its rows r = 0,
    1; a butterfly over g (xor 1, 2, 4 of the lane's row group); then the
    four warps in order."""
    lanes = d.view(4, 2, 8, -1)
    s = lanes[:, 0] + lanes[:, 1]                 # (warp, g, col)
    s = s + s[:, [g ^ 1 for g in range(8)]]
    s = s + s[:, [g ^ 2 for g in range(8)]]
    s = s + s[:, [g ^ 4 for g in range(8)]]
    w = s[:, 0]
    return ((w[0] + w[1]) + w[2]) + w[3]


def block_sums_rows(d: torch.Tensor) -> torch.Tensor:
    """Column sums of a 64-row block in the dx launch's order: warp w adds
    rows w, w + 8, ... from zero, then the eight warps in order."""
    warps = []
    for w in range(8):
        acc = torch.zeros(d.shape[1])
        for r in range(w, d.shape[0], 8):
            acc = acc + d[r]
        warps.append(acc)
    total = warps[0]
    for w in warps[1:]:
        total = total + w
    return total


def reduce_blocks(part: torch.Tensor) -> torch.Tensor:
    """The reduce launch over the row blocks: run g adds blocks g, g + 8, ...
    from zero; the runs are added 0 to 7."""
    runs = []
    for g in range(8):
        acc = torch.zeros(part.shape[1])
        for b in range(g, part.shape[0], 8):
            acc = acc + part[b]
        runs.append(acc)
    total = runs[0]
    for r in runs[1:]:
        total = total + r
    return total


def emulate_backward(x, gamma, beta, w1, b1, w2, dy, rows_per_chunk: int):
    """Kernel 8's six launches: (dx, dgamma, dbeta, dw1, db1, dw2, db2), the
    weight gradients in the (out, in) layout."""
    bf16 = torch.bfloat16
    m, c = x.shape
    x32, dy32 = x.float(), dy.float()
    # norm
    ln, xhat, rstd = ln_two_pass(x32, gamma, beta)
    lnb = ln.to(bf16)
    # hidden
    h = k_steps(lnb, w1.t()) + b1
    da = k_steps(dy, w2)
    g, dg = gelu_parts(h)
    ab, dh = g.to(bf16), da * dg
    dhb = dh.to(bf16)
    blocks = math.ceil(m / BLOCK)
    pad = blocks * BLOCK - m
    dh_pad = torch.cat([dh, dh.new_zeros((pad, dh.shape[1]))])
    db1_part = torch.stack([block_sums_hidden(dh_pad[b * BLOCK:(b + 1) * BLOCK]) for b in range(blocks)])
    # dln, dx
    dln = k_steps(dhb, w1)
    dxh = dln * gamma
    mean1 = dxh.sum(-1, keepdim=True) / c
    mean2 = (dxh * xhat).sum(-1, keepdim=True) / c
    dx = (dy32 + rstd * (dxh - mean1 - xhat * mean2)).to(bf16)
    vec = torch.cat([dln * xhat, dln, dy32], dim=1)
    vec_part = torch.stack([block_sums_rows(vec[b * BLOCK:(b + 1) * BLOCK]) for b in range(blocks)])
    # weights and reduce
    dw2 = dw1 = None
    for r0 in range(0, m, rows_per_chunk):
        rows = slice(r0, r0 + rows_per_chunk)
        p2, p1 = k_steps(dy[rows].t(), ab[rows]), k_steps(dhb[rows].t(), lnb[rows])
        dw2 = p2 if dw2 is None else dw2 + p2
        dw1 = p1 if dw1 is None else dw1 + p1
    vectors = reduce_blocks(torch.cat([vec_part, db1_part], dim=1))
    dgamma, dbeta, db2, db1 = vectors[:c], vectors[c:2 * c], vectors[2 * c:3 * c], vectors[3 * c:]
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


def _inputs(m, c, hidden, seed):
    """numpy inputs at the scales of dinox_torch.bench.fused_mlp_inputs: x,
    the weights and dy rounded to bf16 first, so both sides see the same
    values; weights in the (out, in) layout."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    args = (bf(0.5 * rng.normal(size=(m, c))), f32(1 + 0.1 * rng.normal(size=c)),
            f32(0.1 * rng.normal(size=c)), bf(rng.normal(size=(hidden, c)) * 0.5 / c ** 0.5),
            f32(0.1 * rng.normal(size=hidden)), bf(rng.normal(size=(c, hidden)) * 0.5 / hidden ** 0.5),
            f32(0.1 * rng.normal(size=c)))
    return args, bf(rng.normal(size=(m, c)))


def _jax(args, dy=None):
    """The Pallas wrappers' arguments: rows, (1, C) vectors, JAX-layout
    weights."""
    x, gamma, beta, w1, b1, w2, b2 = (*args, None)[:7]
    bf = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    f = lambda t: jnp.asarray(t.numpy()).reshape(1, -1)  # noqa: E731
    out = [bf(x), f(gamma), f(beta), bf(w1.t()), f(b1), bf(w2.t())]
    return out + ([f(b2)] if dy is None else [bf(dy)])


def test_block_sums_follow_a_plain_sum():
    """The three summation orders add every row once: against a float64 sum
    on rows whose sums are exact in f32."""
    d = torch.arange(64 * 3, dtype=torch.float32).view(64, 3)
    want = d.double().sum(0).float()
    assert torch.equal(block_sums_hidden(d), want)
    assert torch.equal(block_sums_rows(d), want)
    part = torch.arange(20 * 3, dtype=torch.float32).view(20, 3)
    assert torch.equal(reduce_blocks(part), part.double().sum(0).float())


@pytest.mark.parametrize("m,c,hidden,chunk", CASES)
def test_forward_schedule_matches_pallas_kernel_7(m, c, hidden, chunk):
    args, _ = _inputs(m, c, hidden, seed=m + c)
    got = emulate_forward(*args).float().numpy()
    want = np.asarray(jax_fm._fwd(*_jax(args)), np.float32)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert err < Y_TOL and err <= MEASURED_Y, err


@pytest.mark.parametrize("m,c,hidden,chunk", CASES)
def test_backward_schedule_matches_pallas_kernel_8(m, c, hidden, chunk):
    args, dy = _inputs(m, c, hidden, seed=m + c + 1)
    got = emulate_backward(*args[:6], dy, chunk)
    want = jax_fm._bwd(*_jax(args[:6], dy))
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        if i in (3, 5):  # (out, in) against the JAX layout
            g = g.T
        g, w = g.reshape(-1), w.reshape(-1)
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        if i == 0:
            assert err < Y_TOL and err <= MEASURED_DX, (name, err)
        else:
            rel = err / np.abs(w).max()
            assert rel < REL_TOL and rel <= MEASURED_REL, (name, rel)
