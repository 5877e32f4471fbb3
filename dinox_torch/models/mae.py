"""Masked-autoencoder objective (``loss_type="mae"``): the counterpart of
``dinox_tpu.models.mae``.

75% random patch masking (argsort of uniform noise per image), the
PatchViT as encoder over CLS + the visible patches (its ``patch_embed``,
positional table, blocks and final norm; no registers and no scale token),
and a decoder 512 wide, 8 deep with 16 heads (head dim 32) over the
unshuffled sequence with a learned mask token and a fixed 2-D sin-cos
positional table (a buffer, not a parameter), then a per-patch pixel MSE on
the masked patches. The decoder's blocks use the exact erf GELU whatever
the model config says (the JAX decoder builds its blocks with the
TransformerBlock default) and take the encoder's ``attn_impl``, so with
``"pallas"`` their attention is kernel 1 forward and the pair backward at
(B, 257, 1536, 16).

``random_masking`` takes the noise (B, L) itself or a ``torch.Generator``
to draw it from, so the JAX package's ``jax.random.uniform(key, (B, L))``
can be fed in.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from dinox_torch.models.config import ModelConfig
from dinox_torch.models.vit import LayerNorm, Linear, PatchViT, TransformerBlock
from dinox_torch.parallel.collectives import mean_over_group


def sincos_2d(embed_dim: int, grid_size: int, cls_token: bool = True) -> np.ndarray:
    """Fixed 2-D sin-cos table, (1, grid^2 [+1], embed_dim), float32."""
    assert embed_dim % 4 == 0

    def one_dim(dim: int, pos: np.ndarray) -> np.ndarray:
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float32) / (dim / 2))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw, gh = np.meshgrid(np.arange(grid_size, dtype=np.float32), np.arange(grid_size, dtype=np.float32))
    emb = np.concatenate([one_dim(embed_dim // 2, gh), one_dim(embed_dim // 2, gw)], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim), np.float32), emb], axis=0)
    return emb[None].astype(np.float32)


def patchify(imgs: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images -> (B, L, patch*patch*3), pixels in (p, q, c) order."""
    b, hh, ww, c = imgs.shape
    h, w = hh // patch, ww // patch
    x = imgs.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def random_masking(x: torch.Tensor, mask_ratio: float,
                   noise: torch.Tensor | torch.Generator) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image random keep-subset of the L tokens of *x* (B, L, D).
    *noise* is (B, L) uniform noise or a generator to draw it from (on the
    CPU, then moved to x's device). Returns (x_visible, mask (1 on removed
    tokens, x's dtype), ids_restore)."""
    b, length, d = x.shape
    len_keep = int(length * (1.0 - mask_ratio))
    if isinstance(noise, torch.Generator):
        noise = torch.rand((b, length), generator=noise)
    noise = noise.to(x.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_vis = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
    mask = torch.ones((b, length), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0.0
    return x_vis, torch.gather(mask, 1, ids_restore), ids_restore


def decoder_config(cfg: ModelConfig, decoder_dim: int = 512, depth: int = 8, heads: int = 16
                   ) -> ModelConfig:
    """The decoder blocks' config: exact GELU, no fused half-blocks, no LoRA,
    no MoE, the encoder's attention and compute dtype."""
    return ModelConfig(name="mae-decoder", img_size=cfg.img_size, patch=cfg.patch, dim=decoder_dim,
                       depth=depth, heads=heads, mlp_ratio=cfg.mlp_ratio, num_registers=0,
                       attn_impl=cfg.attn_impl, gelu_approx=False, dtype=cfg.dtype)


class MaeDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig, embed_dim: int, decoder_dim: int = 512,
                 decoder_depth: int = 8, decoder_heads: int = 16):
        super().__init__()
        dcfg = decoder_config(cfg, decoder_dim, decoder_depth, decoder_heads)
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
        self.compute_dtype = dt
        self.decoder_embed = Linear(embed_dim, decoder_dim)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_dim))
        self.blocks = nn.ModuleList(TransformerBlock(dcfg, dt) for _ in range(decoder_depth))
        self.decoder_norm = LayerNorm(decoder_dim, torch.float32)
        self.decoder_pred = Linear(decoder_dim, cfg.patch * cfg.patch * 3)
        grid = int(cfg.n_patches ** 0.5)
        self.register_buffer("pos", torch.from_numpy(sincos_2d(decoder_dim, grid)), persistent=False)

    def forward(self, latent: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.decoder_embed(latent)
        b, _, width = x.shape
        n_masked = ids_restore.shape[1] + 1 - x.shape[1]
        body = torch.cat([x[:, 1:], self.mask_token.to(dt).expand(b, n_masked, width)], dim=1)
        body = torch.gather(body, 1, ids_restore[:, :, None].expand(-1, -1, width))  # unshuffle
        x = torch.cat([x[:, :1], body], dim=1) + self.pos.to(dt)
        for blk in self.blocks:
            x = blk(x)
        x = self.decoder_pred(self.decoder_norm(x))
        return x[:, 1:]


class MaeModel(nn.Module):
    """Encoder (a PatchViT) + :class:`MaeDecoder`. ``state_dict()`` keys are
    ``encoder.*`` and ``decoder.*`` (``zoo.interop.jax_to_torch_mae``).
    Parameters are made on the CPU from *generator* (seed 0 when None), then
    moved to *device*."""

    def __init__(self, cfg: ModelConfig, decoder_dim: int = 512, mask_ratio: float = 0.75, *,
                 device: torch.device | str | None = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg, self.mask_ratio = cfg, mask_ratio
        # The JAX encoder never calls its ScaleEmbedding, so it has no parameters.
        self.encoder = PatchViT(cfg.replace(scale_aware=False), generator=g)
        self.decoder = MaeDecoder(cfg, cfg.dim, decoder_dim)
        with torch.no_grad():  # flax: xavier dense kernels, zero biases, mask token N(0, 0.02)
            for m in self.decoder.modules():
                if isinstance(m, Linear):
                    nn.init.xavier_uniform_(m.weight, generator=g)
                    m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            self.decoder.mask_token.normal_(0.0, 0.02, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, imgs: torch.Tensor, noise: torch.Tensor | torch.Generator
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """imgs (B, H, W, 3) -> (pred (B, L, p*p*3) f32, mask (B, L))."""
        enc = self.encoder
        dt = enc.compute_dtype
        b = imgs.shape[0]
        pos = enc.pos_embed.to(dt)
        x = enc.patch_tokens(imgs) + pos[:, 1:]
        x_vis, mask, ids_restore = random_masking(x, self.mask_ratio, noise)
        cls = (enc.cls_token.to(dt) + pos[:, :1]).expand(b, -1, -1)
        latent = enc.run_final_norm(enc.run_blocks(torch.cat([cls, x_vis], dim=1)))
        return self.decoder(latent.to(dt), ids_restore), mask


def mae_loss(pred: torch.Tensor, imgs: torch.Tensor, mask: torch.Tensor, patch: int,
             group=None) -> torch.Tensor:
    """Per-patch MSE averaged over the masked patches only. Every image masks
    the same number of patches, so with a data-parallel *group* the global
    mean is the group mean of the ranks' (``mean_over_group``)."""
    target = patchify(imgs.float(), patch)
    per_patch = torch.mean((pred.float() - target) ** 2, dim=-1)
    return mean_over_group(torch.sum(per_patch * mask) / torch.clamp(torch.sum(mask), min=1.0), group)


def init_mae(cfg: ModelConfig, seed: int = 0, device: torch.device | str | None = None,
             mask_ratio: float = 0.75) -> MaeModel:
    """A fresh MaeModel from *seed*."""
    return MaeModel(cfg, mask_ratio=mask_ratio, device=device,
                    generator=torch.Generator().manual_seed(seed))
