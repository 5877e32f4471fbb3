"""PatchViT with ScaleEmbedding in PyTorch: the counterpart of
``dinox_tpu.models.vit``.

Parameter names are the timm-style keys of ``zoo.interop``, so
``state_dict()`` is a hub/reference state dict. Parameters are float32; the
compute dtype is ``cfg.dtype``. The arithmetic follows the JAX package's
rounding points:

* The residual stream stays in the compute dtype; ``embed`` returns it.
* A dense layer rounds ``x @ W`` to the compute dtype and *then* adds the
  bias in that dtype (``F.linear`` would add it before rounding).
* LayerNorms take float32 statistics with the fast variance
  E[x^2] - E[x]^2 clipped at 0 (flax's default). Block and ScaleEmbedding
  norms output the compute dtype; the final norm is float32.
* The MLP's GELU follows ``cfg.gelu_approx`` (tanh by default);
  ScaleEmbedding always uses the exact erf GELU.
* Patch embedding is unfold + matmul on NHWC input, the same function as the
  JAX package's VALID strided conv.
* Token order [CLS, patches, registers]; the scale token is added to CLS and
  patches before the registers are appended, and skipped without spacing.
* Attention is the packed-QKV kernel (``ops.flash_attention``, kernel 1)
  for ``attn_impl="pallas"`` (its plain version for a CPU tensor). ``"xla"``
  is the JAX package's ``sdpa_xla`` on head-major q, k, v: logits in f32
  with the scale applied to them, softmax normalised in f32, P rounded to
  the compute dtype before PV. :func:`sdpa` dispatches head-major attention
  as the JAX package's does: ``impl="pallas"`` on a CUDA tensor takes the
  head-major kernel (``ops.flash_attention.flash_attention``, kernel 4),
  everything else ``sdpa_xla``.
* ``fused_attn`` (with ``attn_impl="pallas"``, no LoRA) routes each block's
  attention half through the fused half-block (``ops.fused_attn_block``,
  kernel 6); ``fused_mlp`` (exact GELU, no LoRA) routes its MLP half through
  ``ops.fused_mlp`` (kernels 7 and 8). Both keep the JAX package's fused
  rounding points (f32 biases and residual, one rounding each), read the
  same parameters, and leave ``state_dict()`` unchanged; a tanh-GELU config
  keeps the unfused MLP, as in the JAX package.
* ``lora_rank > 0`` gives each ``qkv``/``proj``/``fc1``/``fc2`` named in
  ``cfg.lora_targets`` the LoRA factors ``lora_A.weight`` (r, in) and
  ``lora_B.weight`` (out, r) (:class:`Linear`), so ``state_dict()`` keys
  are peft's without their ``base_model.model.`` prefix. Adapted blocks
  keep off the fused half-blocks, as in the JAX package; their attention
  is kernel 1 forward and kernels 2/3 backward.
* ``moe_experts > 0`` puts a Switch top-1 MoE MLP (``models.moe.MoeMlp``,
  under ``blocks.N.moe``) in place of the MLP of every block with
  ``N % moe_every == moe_every - 1``, after ``norm2``, as the JAX package
  does; such a block takes no fused MLP and no LoRA on its MLP half. Each
  MoE block returns its load-balance loss beside its output
  (:meth:`TransformerBlock.forward_with_aux`), so the loss and its gradient
  come out of a checkpointed block's recomputation like the output;
  :meth:`PatchViT.forward_with_aux` averages them over the MoE blocks.
* ``use_grad_checkpoint`` recomputes each block in the backward
  (``torch.utils.checkpoint``), only in training mode, like the JAX
  package's ``nn.remat`` under ``train=True``. The recomputation replays
  the LoRA dropout masks of the forward (the LoRA generators' states are
  noted per block and set back), as ``nn.remat`` replays its flax rng.

:class:`DinoStudentTeacher` adds the DINO head on CLS; its ``state_dict()``
keys are ``backbone.*``, ``head.0.*`` and ``head.2.*``, the keys of
``zoo.interop.jax_to_torch_student``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dinox_torch.models.config import ModelConfig
from dinox_torch.models.moe import MoeMlp
from dinox_torch.ops.flash_attention import flash_attention, flash_attention_packed
from dinox_torch.ops.flash_attention import mha_attention_reference as sdpa_xla
from dinox_torch.ops.fused_attn_block import fused_attn_block
from dinox_torch.ops.fused_mlp import fused_mlp_block

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ATTN_IMPLS = ("pallas", "xla")

# flax's truncated_normal(stddev) truncates at +-2 and rescales so the
# truncated distribution has the requested stddev.
_TRUNC_STD = 0.87962566103423978


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """Attention dispatch, ``(B, H, N, hd)`` each: the head-major kernel for
    ``impl="pallas"`` on a CUDA tensor, :func:`sdpa_xla` otherwise."""
    if impl == "pallas" and q.device.type == "cuda":
        return flash_attention(q, k, v)
    return sdpa_xla(q, k, v)


class LoraFactor(nn.Module):
    """One LoRA factor, a bias-free weight: ``lora_A`` (r, in), ``lora_B`` (out, r)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))


class Linear(nn.Module):
    """Dense layer: ``x @ W^T`` rounded to x's dtype, then ``+ b`` in that dtype.

    With *lora* = (rank, alpha, dropout) it also owns the factors ``lora_A``
    and ``lora_B`` (the peft names) and adds ``(alpha / r) * dropout(x) @ A^T
    @ B^T`` with the JAX package's rounding points: ``h @ A^T`` rounds to x's
    dtype before the scale, then ``@ B^T`` and the sum in that dtype.
    Dropout acts only in training mode, with masks drawn from ``generator``
    (a ``torch.Generator`` on x's device that the caller sets)."""

    def __init__(self, in_features: int, out_features: int,
                 lora: Optional[tuple[int, float, float]] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.lora_rank = 0
        if lora:
            self.lora_rank, alpha, self.lora_dropout = int(lora[0]), float(lora[1]), float(lora[2])
            self.lora_scale = alpha / self.lora_rank
            self.lora_A = LoraFactor(in_features, self.lora_rank)
            self.lora_B = LoraFactor(self.lora_rank, out_features)
            self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.to(x.dtype).t()) + self.bias.to(x.dtype)
        if not self.lora_rank:
            return y
        h = x
        if self.training and self.lora_dropout > 0.0:
            if self.generator is None:
                raise ValueError("LoRA dropout in training mode needs a generator "
                                 "(PatchViT.set_lora_generator)")
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.lora_dropout
            h = torch.where(keep, x / (1.0 - self.lora_dropout), torch.zeros_like(x))
        t = torch.matmul(h, self.lora_A.weight.to(x.dtype).t()) * self.lora_scale
        return y + torch.matmul(t, self.lora_B.weight.to(x.dtype).t())


class LayerNorm(nn.Module):
    """flax LayerNorm: float32 fast-variance statistics, output in ``out_dtype``."""

    def __init__(self, dim: int, out_dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.out_dtype = out_dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.out_dtype)


class PatchEmbed(nn.Module):
    """NHWC images -> (B, n_patches, dim), row-major patch order; weight in the
    timm/conv layout (dim, 3, p, p)."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(dim, 3, patch, patch))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        wt = self.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return torch.matmul(x, wt.t()) + self.bias.to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with a fused ``qkv`` projection and ``proj``."""

    def __init__(self, dim: int, heads: int, attn_impl: str, lora=lambda name: None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.heads = heads
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, 3 * dim, lora("qkv"))
        self.proj = Linear(dim, dim, lora("proj"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        if self.attn_impl == "pallas":
            out = flash_attention_packed(qkv, self.heads)
        else:
            b, n, c = x.shape
            q, k, v = qkv.view(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
            out = sdpa(q, k, v, impl="xla").transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu_approx: bool, lora=lambda name: None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, lora("fc1"))
        self.fc2 = Linear(hidden, dim, lora("fc2"))
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


def takes_fused_attn(cfg: ModelConfig) -> bool:
    """The JAX package's condition for the fused attention half-block (the
    mesh condition does not apply on one card)."""
    return cfg.fused_attn and not cfg.lora_rank and cfg.attn_impl == "pallas"


def takes_fused_mlp(cfg: ModelConfig) -> bool:
    """The fused MLP half-block computes exact GELU only: a tanh config keeps
    the unfused MLP, as LoRA does."""
    return cfg.fused_mlp and not cfg.lora_rank and not cfg.gelu_approx


class TransformerBlock(nn.Module):
    """Pre-norm block; the residual stream stays in the compute dtype. The
    fused paths read the same submodules' parameters."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, moe: bool = False):
        super().__init__()
        def lora(name: str) -> Optional[tuple[int, float, float]]:
            if cfg.lora_rank > 0 and name in cfg.lora_targets:
                return cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout
            return None

        self.norm1 = LayerNorm(cfg.dim, dtype)
        self.attn = Attention(cfg.dim, cfg.heads, cfg.attn_impl, lora)
        self.norm2 = LayerNorm(cfg.dim, dtype)
        if moe:
            self.moe = MoeMlp(cfg.dim, cfg.moe_experts, cfg.mlp_ratio, cfg.moe_capacity_factor,
                              cfg.gelu_approx)
        else:
            self.mlp = Mlp(cfg.dim, int(cfg.dim * cfg.mlp_ratio), cfg.gelu_approx, lora)
        self.fused_attn = takes_fused_attn(cfg)
        self.fused_mlp = takes_fused_mlp(cfg) and not moe

    def forward_with_aux(self, x: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(output, the MoE load-balance loss or None for a dense block)."""
        if self.fused_attn:
            a = self.attn
            x = fused_attn_block(x, self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
                                 a.proj.weight, a.proj.bias, a.heads)
        else:
            x = x + self.attn(self.norm1(x))
        if hasattr(self, "moe"):
            y, aux = self.moe(self.norm2(x))
            return x + y, aux
        if self.fused_mlp:
            m = self.mlp
            return fused_mlp_block(x, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                                   m.fc2.weight, m.fc2.bias), None
        return x + self.mlp(self.norm2(x)), None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(x)[0]


class ScaleEmbedding(nn.Module):
    """Physical spacing (sx, sy, slice thickness in mm) -> (B, 1, dim):
    3 -> max(dim//4, 16) -> exact GELU -> dim -> LayerNorm. The output layer
    starts at zero, so a fresh ScaleEmbedding is a no-op."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        hidden = max(dim // 4, 16)
        self.dtype = dtype
        self.mlp = nn.Sequential(Linear(3, hidden), nn.GELU(), Linear(hidden, dim),
                                 LayerNorm(dim, dtype))

    def forward(self, spacing: torch.Tensor) -> torch.Tensor:
        return self.mlp(spacing.to(self.dtype))[:, None, :]


def _check_config(cfg: ModelConfig) -> None:
    unknown = set(cfg.lora_targets) - {"qkv", "proj", "fc1", "fc2"}
    if cfg.lora_rank > 0 and unknown:
        raise ValueError(f"unknown LoRA target modules: {sorted(unknown)}")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"compute dtype {cfg.dtype!r} not supported (one of {sorted(DTYPES)})")


class PatchViT(nn.Module):
    """Patch ViT with optional ScaleEmbedding.

    Input: NHWC float images (B, H, W, 3) and optional spacing (B, 3). Returns
    all tokens (B, N, dim) in float32 after the final LayerNorm; token order
    [CLS, patches, registers]. Parameters are made on the CPU from
    *generator* (seed 0 when None), then moved to *device*."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.compute_dtype = DTYPES[cfg.dtype]
        d = cfg.dim
        self.patch_embed = PatchEmbed(cfg.patch, d)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.n_patches, d))
        if cfg.num_registers > 0:
            self.registers = nn.Parameter(torch.empty(1, cfg.num_registers, d))
        if cfg.scale_aware:
            self.scale_embed = ScaleEmbedding(d, self.compute_dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, self.compute_dtype,
                             moe=cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1)
            for i in range(cfg.depth))
        self.norm = LayerNorm(d, torch.float32)
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initialisers (xavier-uniform dense kernels, zero
        biases, unit LayerNorm scales, truncated normals for the patch
        embedding and tokens, a zero ScaleEmbedding output layer)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def trunc(t: torch.Tensor, std: float) -> None:
            s = std / _TRUNC_STD
            nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=g)

        for m in self.modules():
            if isinstance(m, Linear):
                nn.init.xavier_uniform_(m.weight, generator=g)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        trunc(self.patch_embed.weight, 0.02)
        self.patch_embed.bias.zero_()
        trunc(self.cls_token, 0.02)
        trunc(self.pos_embed, 0.1)
        for m in self.modules():
            if isinstance(m, MoeMlp):  # flax: router truncated normal, experts xavier per expert
                trunc(m.router.weight, 0.02)
                for w in (m.w1, m.w2):
                    bound = (6.0 / (w.shape[1] + w.shape[2])) ** 0.5
                    w.copy_(torch.rand(w.shape, generator=g) * (2 * bound) - bound)
        if self.cfg.num_registers > 0:
            trunc(self.registers, 0.02)
        if self.cfg.scale_aware:
            self.scale_embed.mlp[2].weight.zero_()
            self.scale_embed.mlp[3].weight.fill_(self.cfg.scale_gamma_init)
        self.reset_lora_parameters(g)

    def lora_layers(self) -> list[Linear]:
        return [m for m in self.modules() if isinstance(m, Linear) and m.lora_rank]

    @torch.no_grad()
    def reset_lora_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh LoRA factors, as peft (and the JAX package) make them: B
        zero, so the adapter starts as a no-op; A kaiming-uniform (bound
        sqrt(1 / fan_in)), drawn from *generator* on the CPU (seed 0 when
        None)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.lora_layers():
            a = m.lora_A.weight
            bound = (1.0 / a.shape[1]) ** 0.5
            a.copy_(torch.rand(a.shape, generator=g) * (2 * bound) - bound)
            m.lora_B.weight.zero_()

    def set_lora_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every LoRA dropout draws its masks from."""
        for m in self.lora_layers():
            m.generator = generator

    def patch_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, n_patches, dim) in the compute dtype, row-major
        patch order."""
        return self.patch_embed(x.to(self.compute_dtype))

    def embed(self, x: torch.Tensor, spacing: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Patch embed + CLS + positional + scale token + registers -> (B, N, dim)."""
        dt = self.compute_dtype
        b = x.shape[0]
        x = self.patch_tokens(x)
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed.to(dt)
        if self.cfg.scale_aware and spacing is not None:
            x = x + self.scale_embed(spacing)
        if self.cfg.num_registers > 0:
            x = torch.cat([x, self.registers.to(dt).expand(b, -1, -1)], dim=1)
        return x

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        return self.run_blocks_with_aux(x)[0]

    def run_blocks_with_aux(self, x: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block stack; returns (tokens, the mean MoE load-balance loss
        over the MoE blocks, or None without MoE)."""
        remat = self.cfg.use_grad_checkpoint and self.training and torch.is_grad_enabled()
        generators = list({id(m.generator): m.generator for m in self.lora_layers()
                           if m.generator is not None}.values()) if remat else []
        auxes = []
        for blk in self.blocks:
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    blk.forward_with_aux, x, use_reentrant=False,
                    context_fn=lambda: _replay_generators(generators))
            else:
                x, aux = blk.forward_with_aux(x)
            if aux is not None:
                auxes.append(aux)
        return x, (sum(auxes) / len(auxes) if auxes else None)

    def enable_fused_attn(self) -> None:
        """Switch every block to the fused attention half-block from now on:
        a run-time kernel choice on the loaded weights (serving's
        ``fused_attn``), the same parameters and outputs."""
        self.cfg = self.cfg.replace(fused_attn=True)
        for blk in self.blocks:
            blk.fused_attn = takes_fused_attn(self.cfg)

    def run_final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.float())

    def forward(self, x: torch.Tensor, spacing: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_with_aux(x, spacing)[0]

    def forward_with_aux(self, x: torch.Tensor, spacing: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(all tokens, the mean MoE load-balance loss or None)."""
        x, aux = self.run_blocks_with_aux(self.embed(x, spacing))
        return self.run_final_norm(x), aux


def _replay_generators(generators: list[torch.Generator]):
    """``torch.utils.checkpoint`` contexts that make a block's recomputation
    draw the LoRA dropout masks its forward drew: the forward context notes
    each generator's state; the recomputation context sets it back, then
    restores the state the generator had before the recomputation, so the
    draws after it are those of a run without checkpointing."""
    states: list[torch.Tensor] = []

    @contextlib.contextmanager
    def forward():
        states[:] = [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, states):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(generators, now):
                g.set_state(s)

    return forward(), recompute()


class DinoHead(nn.Sequential):
    """DINO projection head: dim -> dim -> exact GELU -> out_dim, computed in
    the compute dtype, output float32. Its input (CLS after the f32 final
    norm) is cast to the compute dtype first, as flax's ``Dense(dtype=...)``
    does."""

    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__(Linear(dim, dim), nn.GELU(), Linear(dim, out_dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.dtype)).float()


class DinoStudentTeacher(nn.Module):
    """Backbone + projection head on the CLS token. As in the JAX package,
    the student and the teacher are two instances of this module; the
    teacher is updated by EMA outside it. Parameters are made on the CPU
    from *generator* (seed 0 when None), then moved to *device*."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.backbone = PatchViT(cfg, generator=g)
        self.head = DinoHead(cfg.dim, cfg.out_dim, self.backbone.compute_dtype)
        with torch.no_grad():
            for lin in (self.head[0], self.head[2]):
                nn.init.xavier_uniform_(lin.weight, generator=g)
        if device is not None:
            self.to(device)

    def forward_features(self, x: torch.Tensor, spacing: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (head output (B, out_dim) f32, all tokens (B, N, dim) f32)."""
        return self.forward_features_aux(x, spacing)[:2]

    def forward_features_aux(self, x: torch.Tensor, spacing: Optional[torch.Tensor] = None
                             ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """:meth:`forward_features` and the mean MoE load-balance loss (None
        without MoE)."""
        feats, aux = self.backbone.forward_with_aux(x, spacing)
        return self.head(feats[:, 0]), feats, aux

    def forward(self, x: torch.Tensor, spacing: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_features(x, spacing)[0]
