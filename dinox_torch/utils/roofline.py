"""Roofline bounds: the least time a card could take for a function's work,
the larger of its bytes over the memory rate and its operations over the
peak rate. Each input is counted read once and each output written once.

    python -m dinox_torch.utils.roofline ["NVIDIA H100 80GB HBM3"]

prints the bound of each of the JAX package's TPU kernels (the functions
that reach ``pl.pallas_call``) at the shapes of the ViT-S training step
(2 x 96 views, N=261, dim 384, 6 heads), kernel 3 at the ViT-G shape it is
taken for (2 views, dim 1408, 16 heads), and kernel 4 also at the
bring-up shape of ``python -m dinox_torch.validate_attention`` (batch 8,
8 heads, N=1024, head dim 64), and each of the three launches of the
port's kernel 6 beside kernel 6's own bound, and each launch of the port's
kernels 7 and 8, on the named card's published peaks (H100 SXM by default).
"""

from __future__ import annotations

import sys

from dinox_torch.utils.flops import card_peaks

BF16, F32 = 2, 4
# (b, n, dim, heads) of the head-major kernel's bring-up gate: q, k, v of
# (8, 8, 1024, 64).
VALIDATE_SHAPE = (8, 1024, 512, 8)
# The CIFAR control's attention, (b, n, dim, heads): 2 x 256 views of 69
# tokens (img 32, patch 4, 4 registers), dim 192 over 6 heads (hd 32).
CIFAR_SHAPE = (512, 69, 192, 6)
# Row chunks of kernel 8's weights launch at the training shape on a 132-SM
# H100 (36 tiles, one CTA per SM; ops.fused_mlp.weight_chunks picks them on
# the card).
MLP_WEIGHT_CHUNKS = 7


def bound_ms(moved_bytes: float, flops: float, peaks: tuple[float, float]) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations") for *peaks* = (FLOP/s, B/s)."""
    t_ops, t_bytes = flops / peaks[0] * 1e3, moved_bytes / peaks[1] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_fwd_work(b: int, n: int, dim: int, heads: int) -> tuple[float, float]:
    """Packed (or head-major) attention forward: qkv in, out out, bf16."""
    hd = dim // heads
    return BF16 * b * n * (3 * dim + dim), 4.0 * b * heads * n * n * hd


def attention_bwd_work(b: int, n: int, dim: int, heads: int) -> tuple[float, float]:
    """Its backward: qkv and dO in, dqkv out; S, dV, dP, dQ, dK products."""
    hd = dim // heads
    return BF16 * b * n * (3 * dim + dim + 3 * dim), 10.0 * b * heads * n * n * hd


def fused_attn_work(b: int, n: int, dim: int, heads: int) -> tuple[float, float]:
    """LN -> QKV -> attention -> proj -> +x: x, f32 LN parameters and
    biases, bf16 weights in; y and, for the backward, qkv and the attention
    output out."""
    hd = dim // heads
    params = F32 * (2 * dim + 3 * dim + dim) + BF16 * (3 * dim * dim + dim * dim)
    moved = BF16 * b * n * (dim + dim + 3 * dim + dim) + params
    return moved, 2.0 * b * n * dim * 4 * dim + 4.0 * b * heads * n * n * hd


def fused_attn_parts_work(b: int, n: int, dim: int, heads: int) -> dict[str, tuple[float, float]]:
    """The three launches of the port's kernel 6, each alone: ``qkv`` (x,
    LN parameters, Wqkv and bqkv in; qkv out), ``attention`` (qkv in, attn
    out) and ``proj`` (attn, x, Wproj and bproj in; y out). qkv and attn
    are written and read back, so the parts' bounds sum to more than
    :func:`fused_attn_work`'s."""
    rows = b * n
    qkv = (BF16 * rows * (dim + 3 * dim) + F32 * (2 * dim + 3 * dim) + BF16 * 3 * dim * dim,
           2.0 * rows * dim * 3 * dim)
    proj = (BF16 * rows * 3 * dim + F32 * dim + BF16 * dim * dim, 2.0 * rows * dim * dim)
    return {"qkv": qkv, "attention": attention_fwd_work(b, n, dim, heads), "proj": proj}


def fused_mlp_fwd_work(rows: int, dim: int, hidden: int) -> tuple[float, float]:
    """LN -> fc1 -> GELU -> fc2 -> +x over *rows* tokens."""
    params = F32 * (2 * dim + hidden + dim) + BF16 * 2 * dim * hidden
    return BF16 * rows * dim * 2 + params, 4.0 * rows * dim * hidden


def fused_mlp_bwd_work(rows: int, dim: int, hidden: int) -> tuple[float, float]:
    """Its backward: x, dy and the parameters in; dx and the f32 parameter
    gradients out; fc1 recomputed, dW2, dh, dW1 and dx (five products)."""
    params_in = F32 * (2 * dim + hidden) + BF16 * 2 * dim * hidden
    grads_out = F32 * (2 * dim + hidden + dim + 2 * dim * hidden)
    return BF16 * rows * dim * 3 + params_in + grads_out, 10.0 * rows * dim * hidden


def fused_mlp_fwd_parts_work(rows: int, dim: int, hidden: int) -> dict[str, tuple[float, float]]:
    """The two launches of the port's kernel 7, each alone: ``fc1`` (x, LN
    parameters, W1 and b1 in; the bf16 activation a out) and ``fc2`` (a, x,
    W2 and b2 in; y out). a is written and read back, so the parts' bounds
    sum to more than :func:`fused_mlp_fwd_work`'s."""
    fc1 = (BF16 * rows * (dim + hidden) + F32 * (2 * dim + hidden) + BF16 * dim * hidden,
           2.0 * rows * dim * hidden)
    fc2 = (BF16 * rows * (hidden + 2 * dim) + F32 * dim + BF16 * dim * hidden,
           2.0 * rows * dim * hidden)
    return {"fc1": fc1, "fc2": fc2}


def fused_mlp_bwd_parts_work(rows: int, dim: int, hidden: int, chunks: int,
                             block: int = 64) -> dict[str, tuple[float, float]]:
    """The six launches of the port's kernel 8, each alone, for *chunks* row
    chunks of the weights launch and partial sums per *block* rows:
    ``norm`` (x, gamma, beta in; lnb out), ``hidden`` (lnb, dy, W1, b1, W2
    in; ab, dhb and the blocks' db1 partials out), ``dln`` (dhb, W1 in; f32
    dln out), ``dx`` (x, gamma, dln, dy in; dx and the blocks' dgamma, dbeta,
    db2 partials out), ``weights`` (dy, ab, dhb, lnb in; one f32 partial of
    dW2 and dW1 per chunk out) and ``reduce`` (the partials in; the f32
    gradients out). lnb, ab, dhb, dln and the partials go through device
    memory, so the parts' bounds sum to more than
    :func:`fused_mlp_bwd_work`'s; their products are its five."""
    blocks = -(-rows // block)
    weights = BF16 * 2 * dim * hidden
    grads = F32 * 2 * dim * hidden
    vectors = 3 * dim + hidden
    return {
        "norm": (BF16 * rows * dim * 2 + F32 * 2 * dim, 0.0),
        "hidden": (BF16 * rows * (2 * dim + 2 * hidden) + weights + F32 * hidden
                   + F32 * blocks * hidden, 4.0 * rows * dim * hidden),
        "dln": (BF16 * rows * hidden + BF16 * dim * hidden + F32 * rows * dim,
                2.0 * rows * dim * hidden),
        "dx": (BF16 * rows * dim * 3 + F32 * rows * dim + F32 * dim + F32 * blocks * 3 * dim, 0.0),
        "weights": (BF16 * rows * (2 * dim + 2 * hidden) + chunks * grads,
                    4.0 * rows * dim * hidden),
        "reduce": (chunks * grads + F32 * blocks * vectors + grads + F32 * vectors, 0.0),
    }


def layer_norm_fwd_work(rows: int, dim: int, x_bytes: int = BF16, y_bytes: int = BF16,
                        stats: bool = True) -> tuple[float, float]:
    """The port's LayerNorm forward (``ops.layer_norm``): x, gamma, beta in;
    y out, and each row's f32 mean and rstd where a backward follows.
    Memory bounds it; the operations counted are ~8 a column."""
    return (rows * dim * (x_bytes + y_bytes) + F32 * 2 * dim + (F32 * 2 * rows if stats else 0),
            8.0 * rows * dim)


def layer_norm_bwd_work(rows: int, dim: int, x_bytes: int = BF16, dy_bytes: int = BF16
                        ) -> tuple[float, float]:
    """Its backward, both launches as one function: x, dy, gamma and the
    rows' mean and rstd in; dx, dgamma and dbeta out (the per-CTA partial
    sums between the launches are not the function's bytes)."""
    return (rows * dim * (2 * x_bytes + dy_bytes) + F32 * 2 * rows + F32 * 3 * dim,
            14.0 * rows * dim)


def rope_work(views: int, patches: int, dim: int, heads: int) -> tuple[float, float]:
    """The RoPE rotation (``ops.rope``), forward or backward: the q and k
    columns of the patch rows read and written, bf16, and the f32 cos and
    sin tables read; 3 operations a rotated element. The backward kernel
    also copies v and the unrotated rows (it works out of place): not the
    function's bytes."""
    rotated = views * patches * 2 * dim
    return 2.0 * BF16 * rotated + F32 * patches * (dim // heads), 3.0 * rotated


def swiglu_fwd_work(rows: int, hidden: int) -> tuple[float, float]:
    """The SwiGLU gate (``ops.swiglu``): ``[u | g]`` in, z out, bf16."""
    return BF16 * rows * 3.0 * hidden, 4.0 * rows * hidden


def swiglu_bwd_work(rows: int, hidden: int) -> tuple[float, float]:
    """Its backward: ``[u | g]`` and dz in, ``[du | dg]`` out."""
    return BF16 * rows * 5.0 * hidden, 10.0 * rows * hidden


def tpu_kernel_bounds(peaks: tuple[float, float], views: int = 192, n: int = 261,
                      dim: int = 384, heads: int = 6, mlp_ratio: float = 4.0,
                      giant: tuple[int, int, int, int] = (2, 261, 1408, 16)) -> list[dict]:
    """One row per TPU kernel: number, function, shape, bytes, FLOPs, bound."""
    hidden = int(dim * mlp_ratio)
    step = (views, n, dim, heads)
    rows = [
        (1, "_packed_kernel", step, attention_fwd_work(*step)),
        (2, "_packed_bwd_kernel", step, attention_bwd_work(*step)),
        (3, "_packed_bwd_dq_kernel + _packed_bwd_dkv_kernel", giant, attention_bwd_work(*giant)),
        (4, "_mha_kernel", step, attention_fwd_work(*step)),
        (5, "_mha_bwd_kernel", step, attention_bwd_work(*step)),
        (6, "_fused_kernel (fused_attn_block)", step, fused_attn_work(*step)),
        (7, "fused_mlp _fwd_kernel", (views * n, dim, hidden),
         fused_mlp_fwd_work(views * n, dim, hidden)),
        (8, "fused_mlp _bwd_kernel", (views * n, dim, hidden),
         fused_mlp_bwd_work(views * n, dim, hidden)),
    ]
    out = []
    for num, name, shape, (moved, flops) in rows:
        ms, by = bound_ms(moved, flops, peaks)
        out.append({"kernel": num, "function": name, "shape": shape, "mbytes": moved / 1e6,
                    "gflop": flops / 1e9, "bound_ms": ms, "bound_by": by})
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    card = argv[0] if argv else "NVIDIA H100 80GB HBM3"
    peaks = card_peaks(card)
    print(f"# {card}: {peaks[0] / 1e12:.0f} TFLOP/s bf16 dense, {peaks[1] / 1e12:.2f} TB/s")
    for r in tpu_kernel_bounds(peaks):
        print(f"{r['kernel']}  {r['function']:48s} {str(r['shape']):22s} {r['mbytes']:9.1f} MB "
              f"{r['gflop']:8.2f} GFLOP  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    step = (192, 261, 384, 6)
    for part, (moved, flops) in fused_attn_parts_work(*step).items():
        ms, by = bound_ms(moved, flops, peaks)
        print(f"6  {'  launch ' + part:48s} {str(step):22s} {moved / 1e6:9.1f} MB "
              f"{flops / 1e9:8.2f} GFLOP  bound {ms:.4f} ms ({by})")
    rows, dim, hidden = 192 * 261, 384, 1536
    mlp_parts = [(7, fused_mlp_fwd_parts_work(rows, dim, hidden)),
                 (8, fused_mlp_bwd_parts_work(rows, dim, hidden, MLP_WEIGHT_CHUNKS))]
    for num, parts in mlp_parts:
        for part, (moved, flops) in parts.items():
            ms, by = bound_ms(moved, flops, peaks)
            print(f"{num}  {'  launch ' + part:48s} {str((rows, dim, hidden)):22s} "
                  f"{moved / 1e6:9.1f} MB {flops / 1e9:8.2f} GFLOP  bound {ms:.4f} ms ({by})")
    for num, label, shape, work in ((4, "_mha_kernel at the validate shape", VALIDATE_SHAPE,
                                     attention_fwd_work),
                                    (1, "_packed_kernel at the CIFAR shape", CIFAR_SHAPE,
                                     attention_fwd_work),
                                    (2, "_packed_bwd_kernel at the CIFAR shape", CIFAR_SHAPE,
                                     attention_bwd_work)):
        moved, flops = work(*shape)
        ms, by = bound_ms(moved, flops, peaks)
        print(f"{num}  {label:48s} {str(shape):22s} "
              f"{moved / 1e6:9.1f} MB {flops / 1e9:8.2f} GFLOP  bound {ms:.4f} ms ({by})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
