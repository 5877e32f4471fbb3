"""Packed-QKV multi-head attention, forward and backward: hand-written Hopper
kernels and their plain PyTorch versions.

Forward: replaces ``_packed_kernel`` (dinox_tpu/ops/flash_attention.py,
reached through ``_packed_fwd`` and ``flash_attention_packed``). The kernel
is ``csrc/packed_attention.cu``: it reads q, k and v as hd-wide column
slices of the packed ``(B, N, 3*dim)`` row and writes the token-major
``(B, N, dim)`` output, with no transposes on either side. Bound on an H100
SXM at the ViT-S training shape (B=192, N=261, dim 384, 6 heads): 153.9 MB
of qkv in and output out against 20.1 GFLOP, so memory bounds it (46 us at
3.35 TB/s; 7.7 us at the serving shape B=32). The design, the forward tile
core ``csrc/attention_fwd_sm90.cuh`` (shared with kernel 4): K/V tiles come
by TMA into a two-stage shared-memory ring fed by a producer warp, so loads
overlap the products; the tensor cores run through ``wgmma`` (bf16 x bf16 ->
f32), with S, P and the f32 output accumulator in registers; the last key
tile is multiplied at the narrowest of 16, 32 or 64 keys that covers N (272
keys, not 320, at N=261). One pass with an online softmax.

Backward: replaces ``_packed_bwd_kernel`` (``_packed_bwd``) and its split
form ``_packed_bwd_dq_kernel`` + ``_packed_bwd_dkv_kernel``
(``_packed_bwd_split``). The kernels are ``csrc/packed_attention_bwd.cu``: a
dq kernel over query tiles, which also saves each row's softmax statistics,
then a dkv kernel over key tiles; together they write the packed
``(B, N, 3*dim)`` dqkv. Bound at the ViT-S training shape (192 views):
269 MB moved against 50.2 GFLOP, memory-bound (80 us at 3.35 TB/s). Both run
on the backward tile core ``csrc/attention_bwd_sm90.cuh`` (shared with
kernel 5), built from the forward core's TMA and ``wgmma`` pieces: a
producer warp streams K/V (dq) or Q/dO and the statistics (dkv) into a
two-stage ring, one consumer warpgroup keeps S, dP, P, dS and the f32
accumulators in registers; no atomics, so the same inputs give the same
bits.

:func:`flash_attention_packed` is differentiable through a
``torch.autograd.Function`` that saves only qkv, as the JAX package's VJP
rule does. For a CPU tensor it runs the plain versions; for a CUDA tensor it
launches the kernels or raises. Launch counts: ``flash_attention_packed
.launches`` (forward), ``packed_attention_bwd_dq.launches`` and
``packed_attention_bwd_dkv.launches`` (backward).

Head-major ``(B, H, N, hd)`` attention, the JAX package's
``flash_attention``: :func:`flash_attention` replaces ``_mha_kernel``
(kernel 4, ``_flash_fwd``) with ``csrc/mha_attention.cu`` and its VJP's
``_mha_bwd_kernel`` (kernel 5, ``_flash_bwd``) with
``csrc/mha_attention_bwd.cu``, a dq + dkv pair that runs the packed
backward's tile core (``csrc/attention_bwd_sm90.cuh``) through head-major
tensor maps. Kernel 4 keeps ``_mha_kernel``'s rounding points, not kernel 1's:
the scale multiplies the f32 logits and P is normalised in f32, then
rounded, then multiplied by V; its plain version
:func:`mha_attention_reference` is the JAX package's ``_xla_sdpa`` /
``sdpa_xla``. It runs on the same forward tile core as kernel 1, in two
passes over the key tiles in one launch (K alone for the row max and sum,
then K and V), because the normalised P needs the final row sum. Bounds on
an H100 SXM at (192, 6, 261, 64): forward 153.9 MB, 46.0 us (bytes);
backward 269.4 MB, 80.4 us (bytes); at (8, 8, 1024, 64) the forward's 17.2
GFLOP bound it at 17.4 us (the two passes issue 25.8). The kernels take any
N (no fallback above 1024). Launch counts: ``flash_attention.launches``,
``mha_attention_bwd_dq.launches`` and ``mha_attention_bwd_dkv.launches``.

Head dims: every kernel takes 32, 64 and 88 (:data:`SUPPORTED_HEAD_DIMS`);
kernels 1-3 also take 128 (:data:`PACKED_HEAD_DIMS`), DINOv3 ViT-7B's 32
heads of 128, at two CTAs an SM (the f32 O, dQ or dK + dV accumulators are
64 to 128 registers a thread there).
"""

from __future__ import annotations

import ctypes

import torch

from dinox_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 88)  # every attention kernel (1-6)
PACKED_HEAD_DIMS = SUPPORTED_HEAD_DIMS + (128,)  # kernels 1-3 also take DINOv3 ViT-7B's heads

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dinox_packed_attention_fwd_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    "dinox_packed_attention_bwd_dq_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dinox_packed_attention_bwd_dkv_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dinox_mha_attention_fwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dinox_mha_attention_bwd_dq_bf16": [_P] * 6 + [_I, _I, _I, _I, _F, _P],
    "dinox_mha_attention_bwd_dkv_bf16": [_P] * 7 + [_I, _I, _I, _I, _F, _P],
}


def _occupancy(name: str, symbol: str, args: tuple[int, ...], device) -> dict[str, int]:
    vals = _build.query(name, symbol, args, device)
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm"), vals))


def forward_occupancy(name: str, hd: int, device: torch.device | str = "cuda") -> dict[str, int]:
    """Registers per thread, dynamic shared memory per CTA (bytes) and
    resident CTAs per SM of the forward kernel of ``csrc/<name>.cu``
    (``packed_attention``: kernel 1, ``mha_attention``: kernel 4) at head dim
    *hd*, from the CUDA occupancy API on *device*."""
    return _occupancy(name, f"dinox_{name}_fwd_occupancy", (hd,), device)


def backward_occupancy(name: str, hd: int, part: str, device: torch.device | str = "cuda"
                       ) -> dict[str, int]:
    """The same for the *part* (``"dq"`` or ``"dkv"``) kernel of the
    backward pair ``csrc/<name>.cu`` (``packed_attention_bwd``: kernels 2/3,
    ``mha_attention_bwd``: kernel 5)."""
    return _occupancy(name, f"dinox_{name}_occupancy", (hd, ("dq", "dkv").index(part)), device)


def _split_heads(t: torch.Tensor, parts: int, heads: int) -> tuple[torch.Tensor, ...]:
    """(B, N, parts*heads*hd) -> *parts* tensors (B, heads, N, hd)."""
    b, n, width = t.shape
    return t.view(b, n, parts, heads, width // parts // heads).permute(2, 0, 3, 1, 4).unbind(0)


def packed_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points:
    qkv ``(B, N, 3*dim)`` ``[q|k|v]`` -> ``(B, N, dim)`` in qkv's dtype.

    The scale is folded into q and rounded to the working dtype, logits are
    f32, the unnormalised exp is cast to the dtype before PV, and the
    division by the row sum comes after PV."""
    b, n, three_dim = qkv.shape
    dim = three_dim // 3
    hd = dim // heads
    q, k, v = _split_heads(qkv, 3, heads)
    q = (q.float() * (1.0 / hd ** 0.5)).to(qkv.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(qkv.dtype).float(), v.float()) / e.sum(dim=-1, keepdim=True)
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, dim)


def packed_attention_backward_reference(qkv: torch.Tensor, do: torch.Tensor,
                                        heads: int) -> torch.Tensor:
    """Plain backward with the TPU kernel's rounding points: qkv
    ``(B, N, 3*dim)`` and the output gradient ``(B, N, dim)`` -> dqkv
    ``(B, N, 3*dim)`` in qkv's dtype.

    s = q k^T * scale in f32 (the scale is not folded into q here);
    P = softmax(s); dV = bf16(P)^T dO; dP = dO V^T; dS = P (dP - rowsum(dP P));
    dQ = bf16(dS * scale) K; dK = bf16(dS * scale)^T Q."""
    b, n, three_dim = qkv.shape
    (dob,) = _split_heads(do, 1, heads)
    dqkv = torch.stack(mha_attention_backward_reference(*_split_heads(qkv, 3, heads), dob))
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, three_dim)  # from (3, b, heads, n, hd)


def mha_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain head-major attention, ``(B, H, N, hd)`` each -> ``(B, H, N, hd)``
    in q's dtype: the twin of the JAX package's ``_xla_sdpa`` and
    ``sdpa_xla``, and kernel 4's plain version.

    Logits q k^T in f32, the scale applied to them, softmax normalised in
    f32, P rounded to the working dtype before PV, PV in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * (1.0 / q.shape[-1] ** 0.5), dim=-1)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def mha_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     do: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain backward of head-major attention with the TPU kernels' rounding
    points (kernel 5's, which are kernel 2's): ``(B, H, N, hd)`` q, k, v and
    output gradient -> (dq, dk, dv) in q's dtype.

    s = q k^T * scale in f32 (the scale is not folded into q here);
    P = softmax(s); dV = bf16(P)^T dO; dP = dO V^T; dS = P (dP - rowsum(dP P));
    dQ = bf16(dS * scale) K; dK = bf16(dS * scale)^T Q."""
    dt = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    q, k, v, do = (t.float() for t in (q, k, v, do))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = (ds * scale).to(dt).float()
    return (torch.matmul(dsb, k).to(dt), torch.matmul(dsb.transpose(-1, -2), q).to(dt),
            dv.to(dt))


def _check(qkv: torch.Tensor, heads: int) -> int:
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, N, 3*dim), got {tuple(qkv.shape)}")
    dim = qkv.shape[2] // 3
    if dim % heads:
        raise ValueError(f"dim {dim} is not divisible by heads {heads}")
    hd = dim // heads
    if hd not in PACKED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel (supported: {PACKED_HEAD_DIMS})")
    _check_operand(qkv, "qkv")
    return hd


def _check_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the packed attention kernels take bfloat16 {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention for device {qkv.device}")
    hd = _check(qkv, heads)
    b, n, three_dim = qkv.shape
    out = torch.empty((b, n, three_dim // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    symbol = "dinox_packed_attention_fwd_bf16"
    _build.launch("packed_attention", symbol, _SIGNATURES[symbol], qkv.device, qkv.data_ptr(),
                  out.data_ptr(), b, n, heads, hd, 1.0 / hd ** 0.5)
    flash_attention_packed.launches += 1
    return out


def packed_attention_bwd_dq(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                            dqkv: torch.Tensor, stats: torch.Tensor) -> None:
    """Launch the dq kernel: writes the dq slots of *dqkv* and each row's
    softmax max, sum and rowsum(dP*P) to *stats* ``(B*heads, 3, N)`` f32.
    Operands are checked by :func:`packed_attention_backward`."""
    b, n, three_dim = qkv.shape
    hd = three_dim // 3 // heads
    symbol = "dinox_packed_attention_bwd_dq_bf16"
    _build.launch("packed_attention_bwd", symbol, _SIGNATURES[symbol], qkv.device, qkv.data_ptr(),
                  do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, n, heads, hd,
                  1.0 / hd ** 0.5)
    packed_attention_bwd_dq.launches += 1


def packed_attention_bwd_dkv(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                             stats: torch.Tensor, dqkv: torch.Tensor) -> None:
    """Launch the dkv kernel: reads *stats* from the dq kernel and writes the
    dk and dv slots of *dqkv*."""
    b, n, three_dim = qkv.shape
    hd = three_dim // 3 // heads
    symbol = "dinox_packed_attention_bwd_dkv_bf16"
    _build.launch("packed_attention_bwd", symbol, _SIGNATURES[symbol], qkv.device, qkv.data_ptr(),
                  do.data_ptr(), stats.data_ptr(), dqkv.data_ptr(), b, n, heads, hd,
                  1.0 / hd ** 0.5)
    packed_attention_bwd_dkv.launches += 1


packed_attention_bwd_dq.launches = 0
packed_attention_bwd_dkv.launches = 0


def packed_attention_backward(qkv: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """dqkv ``(B, N, 3*dim)`` from qkv and the output gradient ``(B, N, dim)``:
    the plain version for CPU tensors, the dq + dkv kernel pair for CUDA."""
    if qkv.device.type == "cpu":
        return packed_attention_backward_reference(qkv, do, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no packed attention backward for device {qkv.device}")
    _check(qkv, heads)
    b, n, three_dim = qkv.shape
    if do.shape != (b, n, three_dim // 3) or do.device != qkv.device:
        raise ValueError(f"output gradient {tuple(do.shape)} on {do.device} does not match "
                         f"qkv {tuple(qkv.shape)} on {qkv.device}")
    _check_operand(do, "the output gradient")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    stats = torch.empty((b * heads, 3, n), dtype=torch.float32, device=qkv.device)
    packed_attention_bwd_dq(qkv, do, heads, dqkv, stats)
    packed_attention_bwd_dkv(qkv, do, heads, stats, dqkv)
    return dqkv


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return _forward(qkv, heads)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return packed_attention_backward(qkv, do.contiguous(), ctx.heads), None


def flash_attention_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Layout-native fused MHA: qkv ``(B, N, 3*dim)`` ``[q|k|v]`` -> ``(B, N, dim)``,
    differentiable in qkv."""
    return _PackedAttention.apply(qkv, heads)


flash_attention_packed.launches = 0


def flash_attention_packed_sharded(qkv: torch.Tensor, heads: int, mesh) -> torch.Tensor:
    """The multi-rank dispatch of :func:`flash_attention_packed`: the
    counterpart of the JAX package's ``flash_attention_packed_sharded``
    (``dinox_tpu/ops/flash_attention.py:481``), a dispatch and not a kernel.

    *qkv* is this rank's block ``(B/dp, N, 3*dim/tp)``: its own rows of the
    batch, and the q, k and v columns of its ``heads // tp`` heads, packed
    ``[q_r | k_r | v_r]`` as the column-parallel qkv layer lays them out
    (``parallel.mesh.tp_param_spec`` cuts qkv by heads), so no reshard is
    needed. Returns ``(B/dp, N, dim/tp)``, the heads' output columns that the
    row-parallel proj contracts; kernel 1 forward and the dq + dkv pair
    backward run on the block. Raises when *heads* does not divide by the
    model axis or the block's width is not that of ``heads // tp`` heads;
    the batch is cut, and checked, by ``parallel.mesh.batch_rows``."""
    tp = mesh.tp
    if heads % tp:
        raise ValueError(f"heads={heads} not divisible by model axis size {tp}")
    local = heads // tp
    if qkv.shape[-1] % (3 * local):
        raise ValueError(f"qkv width {qkv.shape[-1]} is not that of {local} packed heads")
    return flash_attention_packed(qkv, local)


# -- head-major (B, H, N, hd) attention: kernels 4 and 5 ----------------------


def _check_mha(tensors: dict[str, torch.Tensor], shape: tuple[int, ...]) -> int:
    """Raise unless every tensor is a contiguous, 16-byte aligned bf16
    ``(B, H, N, hd)`` of *shape* on the first one's device with a head dim the
    kernels take. Returns hd."""
    if len(shape) != 4:
        raise ValueError(f"head-major attention takes (B, H, N, hd) tensors, got {shape}")
    if shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {shape[3]} not supported by the kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    device = next(iter(tensors.values())).device
    _build.check_operands({name: (t, shape, torch.bfloat16) for name, t in tensors.items()},
                          device, 16, "head-major attention")
    return shape[3]


def _mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no head-major attention for device {q.device}")
    hd = _check_mha({"q": q, "k": k, "v": v}, tuple(q.shape))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    b, heads, n, _ = q.shape
    symbol = "dinox_mha_attention_fwd_bf16"
    _build.launch("mha_attention", symbol, _SIGNATURES[symbol], q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, n, hd, 1.0 / hd ** 0.5)
    flash_attention.launches += 1
    return out


def mha_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                         dq: torch.Tensor, stats: torch.Tensor) -> None:
    """Launch kernel 5's dq kernel: writes *dq* and each row's softmax max,
    sum and rowsum(dP*P) to *stats* ``(B*H, 3, N)`` f32. Operands are
    checked by :func:`mha_attention_backward`."""
    b, heads, n, hd = q.shape
    symbol = "dinox_mha_attention_bwd_dq_bf16"
    _build.launch("mha_attention_bwd", symbol, _SIGNATURES[symbol], q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), stats.data_ptr(), b,
                  heads, n, hd, 1.0 / hd ** 0.5)
    mha_attention_bwd_dq.launches += 1


def mha_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                          stats: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor) -> None:
    """Launch kernel 5's dkv kernel: reads *stats* from the dq kernel and
    writes *dk* and *dv*."""
    b, heads, n, hd = q.shape
    symbol = "dinox_mha_attention_bwd_dkv_bf16"
    _build.launch("mha_attention_bwd", symbol, _SIGNATURES[symbol], q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, heads, n, hd, 1.0 / hd ** 0.5)
    mha_attention_bwd_dkv.launches += 1


mha_attention_bwd_dq.launches = 0
mha_attention_bwd_dkv.launches = 0


def mha_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each ``(B, H, N, hd)``, from q, k, v and the output
    gradient: the plain version for CPU tensors, kernel 5's dq + dkv pair for
    CUDA."""
    if q.device.type == "cpu":
        return mha_attention_backward_reference(q, k, v, do)
    if q.device.type != "cuda":
        raise ValueError(f"no head-major attention backward for device {q.device}")
    _check_mha({"q": q, "k": k, "v": v, "the output gradient": do}, tuple(q.shape))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    b, heads, n, _ = q.shape
    stats = torch.empty((b * heads, 3, n), dtype=torch.float32, device=q.device)
    mha_attention_bwd_dq(q, k, v, do, dq, stats)
    mha_attention_bwd_dkv(q, k, v, do, stats, dk, dv)
    return dq, dk, dv


class _MhaAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return _mha_forward(q, k, v)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        return mha_attention_backward(*ctx.saved_tensors, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused MHA, ``(B, H, N, hd)`` each -> ``(B, H, N, hd)``, differentiable in
    q, k and v; saves only q, k and v, as the JAX package's VJP rule does."""
    return _MhaAttention.apply(q, k, v)


flash_attention.launches = 0
