"""timm-style state dict <-> JAX-package parameter tree (numpy only).

The port's own parameter names are the timm-style keys, so
:func:`jax_to_torch_backbone` carries the JAX package's parameters (numpy
trees) across into the port unchanged in value:

    timm-style (the port)                  JAX package
    ------------------------------------   -------------------------------
    patch_embed.weight (D,3,p,p)           patch_embed.kernel (p,p,3,D)
    patch_embed.bias                       patch_embed.bias
    cls_token / pos_embed / registers      same names, same shapes
    blocks.N.norm{1,2}.{weight,bias}       blocks_N.norm{1,2}.{scale,bias}
    blocks.N.attn.{qkv,proj}.weight (o,i)  blocks_N.attn.{qkv,proj}.kernel (i,o)
    blocks.N.mlp.{fc1,fc2}.weight          blocks_N.mlp.{fc1,fc2}.kernel (T)
    scale_embed.mlp.0.* / .2.* / .3.*      scale_embed.fc1 / fc2 / norm
    norm.{weight,bias}                     norm.{scale,bias}
    blocks.N.<mod>.<s>.lora_A.weight (r,i) blocks_N.<mod>.<s>.lora_A (i,r)
    blocks.N.<mod>.<s>.lora_B.weight (o,r) blocks_N.<mod>.<s>.lora_B (r,o)
    blocks.N.moe.router.weight (E,D)       blocks_N.moe.router.kernel (D,E)
    blocks.N.moe.{w1,b1,w2,b2}             blocks_N.moe.{w1,b1,w2,b2} (JAX's
                                           (E,D,H), (E,1,H), (E,H,D), (E,1,D))

(an MoE block has ``moe`` where a dense block has ``mlp``), and, for the
DINO student (:func:`jax_to_torch_student`), ``backbone.*``
for the tree's ``backbone`` and ``head.{0,2}.{weight,bias}`` for
``head.{fc1,fc2}.{kernel,bias}``; for the MAE model (:func:`jax_to_torch_mae`)
``encoder.*`` for the tree's ``encoder`` and ``decoder.*`` for its
``decoder`` (blocks as above, ``decoder_{embed,pred}.{weight,bias}``,
``decoder_norm.{weight,bias}`` and ``mask_token``). :func:`jax_layout` gives
the permutation of a port parameter's axes that yields its JAX layout.

Also the legacy-key migration (nn.MultiheadAttention / nn.Sequential names
-> timm-style) so pre-migration checkpoints load.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

_ATTN_OLD = re.compile(
    r"^(.+\.attn)\.(in_proj_weight|in_proj_bias|out_proj\.weight|out_proj\.bias)$"
)
_MLP_OLD = re.compile(r"^((?:.*\.)?blocks\.\d+\.mlp)\.(0\.weight|0\.bias|2\.weight|2\.bias)$")

_ATTN_RENAME = {
    "in_proj_weight": "qkv.weight",
    "in_proj_bias": "qkv.bias",
    "out_proj.weight": "proj.weight",
    "out_proj.bias": "proj.bias",
}
_MLP_RENAME = {
    "0.weight": "fc1.weight",
    "0.bias": "fc1.bias",
    "2.weight": "fc2.weight",
    "2.bias": "fc2.bias",
}


def needs_migration(sd: Mapping[str, Any]) -> bool:
    return any(_ATTN_OLD.match(k) or _MLP_OLD.match(k) for k in sd)


def migrate_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Old nn.MultiheadAttention / nn.Sequential keys -> timm-style. Non-matching
    keys pass through; scale_embed.mlp.* deliberately does NOT match the MLP
    pattern (it keeps Sequential naming)."""
    out: dict[str, Any] = {}
    for k, v in sd.items():
        m = _ATTN_OLD.match(k)
        if m:
            out[f"{m.group(1)}.{_ATTN_RENAME[m.group(2)]}"] = v
            continue
        m = _MLP_OLD.match(k)
        if m:
            out[f"{m.group(1)}.{_MLP_RENAME[m.group(2)]}"] = v
            continue
        out[k] = v
    return out


def strip_prefix(sd: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}


def _np(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def torch_to_jax_backbone(sd: Mapping[str, Any]) -> dict[str, Any]:
    """timm-style PatchViT state dict -> JAX-package params tree (numpy leaves).

    Input keys must already be bare backbone keys (no 'backbone.' prefix, no
    'head.*')."""
    if needs_migration(sd):
        sd = migrate_state_dict(sd)
    params: dict[str, Any] = {}

    def put(path: list[str], value: np.ndarray) -> None:
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, raw in sd.items():
        v = _np(raw)
        if key == "patch_embed.weight":
            put(["patch_embed", "kernel"], np.transpose(v, (2, 3, 1, 0)))
        elif key == "patch_embed.bias":
            put(["patch_embed", "bias"], v)
        elif key in ("cls_token", "pos_embed", "registers"):
            put([key], v)
        elif key == "norm.weight":
            put(["norm", "scale"], v)
        elif key == "norm.bias":
            put(["norm", "bias"], v)
        elif key.startswith("scale_embed.mlp."):
            idx, leaf = key.split(".")[2:4]
            sub = {"0": "fc1", "2": "fc2", "3": "norm"}[idx]
            if sub == "norm":
                put(["scale_embed", "norm", "scale" if leaf == "weight" else "bias"], v)
            elif leaf == "weight":
                put(["scale_embed", sub, "kernel"], v.T)
            else:
                put(["scale_embed", sub, "bias"], v)
        elif key.startswith("blocks."):
            parts = key.split(".")
            blk = f"blocks_{parts[1]}"
            rest, leaf = parts[2:-1], parts[-1]
            if rest[0] in ("norm1", "norm2"):
                put([blk, rest[0], "scale" if leaf == "weight" else "bias"], v)
            elif rest[:2] in (["attn", "qkv"], ["attn", "proj"], ["mlp", "fc1"], ["mlp", "fc2"]) \
                    and len(rest) == 3 and rest[2] in ("lora_A", "lora_B") and leaf == "weight":
                put([blk, rest[0], rest[1], rest[2]], v.T)
            elif rest == ["attn", "qkv"] or rest == ["attn", "proj"]:
                if leaf == "weight":
                    put([blk, "attn", rest[1], "kernel"], v.T)
                else:
                    put([blk, "attn", rest[1], "bias"], v)
            elif rest == ["mlp", "fc1"] or rest == ["mlp", "fc2"]:
                if leaf == "weight":
                    put([blk, "mlp", rest[1], "kernel"], v.T)
                else:
                    put([blk, "mlp", rest[1], "bias"], v)
            elif rest == ["moe", "router"]:
                put([blk, "moe", "router", "kernel" if leaf == "weight" else "bias"],
                    v.T if leaf == "weight" else v)
            elif rest == ["moe"] and leaf in ("w1", "b1", "w2", "b2"):
                put([blk, "moe", leaf], v)
            else:
                raise KeyError(f"unrecognized block key: {key}")
        else:
            raise KeyError(f"unrecognized backbone key: {key}")
    return params


def jax_to_torch_backbone(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Inverse of :func:`torch_to_jax_backbone`: timm-style keys, float32,
    C-contiguous numpy values (MoE expert stacks in JAX's layout)."""
    sd: dict[str, np.ndarray] = {}

    def f32(v: Any) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(v, dtype=np.float32))

    for name, node in params.items():
        if name == "patch_embed":
            sd["patch_embed.weight"] = f32(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
            sd["patch_embed.bias"] = f32(node["bias"])
        elif name in ("cls_token", "pos_embed", "registers"):
            sd[name] = f32(node)
        elif name == "norm":
            sd["norm.weight"] = f32(node["scale"])
            sd["norm.bias"] = f32(node["bias"])
        elif name == "scale_embed":
            sd["scale_embed.mlp.0.weight"] = f32(np.asarray(node["fc1"]["kernel"]).T)
            sd["scale_embed.mlp.0.bias"] = f32(node["fc1"]["bias"])
            sd["scale_embed.mlp.2.weight"] = f32(np.asarray(node["fc2"]["kernel"]).T)
            sd["scale_embed.mlp.2.bias"] = f32(node["fc2"]["bias"])
            sd["scale_embed.mlp.3.weight"] = f32(node["norm"]["scale"])
            sd["scale_embed.mlp.3.bias"] = f32(node["norm"]["bias"])
        elif name.startswith("blocks_"):
            i = name.split("_")[1]
            for ln in ("norm1", "norm2"):
                sd[f"blocks.{i}.{ln}.weight"] = f32(node[ln]["scale"])
                sd[f"blocks.{i}.{ln}.bias"] = f32(node[ln]["bias"])
            if "moe" in node:
                moe = node["moe"]
                sd[f"blocks.{i}.moe.router.weight"] = f32(np.asarray(moe["router"]["kernel"]).T)
                sd[f"blocks.{i}.moe.router.bias"] = f32(moe["router"]["bias"])
                for leaf in ("w1", "b1", "w2", "b2"):
                    sd[f"blocks.{i}.moe.{leaf}"] = f32(moe[leaf])
            for mod, subs in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
                if mod not in node:
                    continue
                for s in subs:
                    sd[f"blocks.{i}.{mod}.{s}.weight"] = f32(np.asarray(node[mod][s]["kernel"]).T)
                    sd[f"blocks.{i}.{mod}.{s}.bias"] = f32(node[mod][s]["bias"])
                    for factor in ("lora_A", "lora_B"):  # flax (i, r) / (r, o) -> (r, i) / (o, r)
                        if factor in node[mod][s]:
                            sd[f"blocks.{i}.{mod}.{s}.{factor}.weight"] = f32(
                                np.asarray(node[mod][s][factor]).T)
        else:
            raise KeyError(f"unrecognized param subtree: {name}")
    return sd


def torch_to_jax_student(sd: Mapping[str, Any]) -> dict[str, Any]:
    """DinoStudentTeacher state dict (backbone.* + head.*) -> JAX-package tree
    {'backbone': ..., 'head': ...} (numpy leaves)."""
    if needs_migration(sd):
        sd = migrate_state_dict(sd)
    bb = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    head_sd = {k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")}
    out: dict[str, Any] = {"backbone": torch_to_jax_backbone(bb)}
    head: dict[str, Any] = {}
    for k, raw in head_sd.items():
        v = _np(raw)
        idx, leaf = k.split(".")
        sub = {"0": "fc1", "2": "fc2"}[idx]
        head.setdefault(sub, {})["kernel" if leaf == "weight" else "bias"] = (
            v.T if leaf == "weight" else v)
    if head:
        out["head"] = head
    return out


def jax_to_torch_student(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Inverse of :func:`torch_to_jax_student`: the port's DinoStudentTeacher
    state dict (float32, C-contiguous numpy values)."""
    sd = {f"backbone.{k}": v for k, v in jax_to_torch_backbone(params["backbone"]).items()}
    if "head" in params:
        for sub, idx in (("fc1", "0"), ("fc2", "2")):
            sd[f"head.{idx}.weight"] = np.ascontiguousarray(
                np.asarray(params["head"][sub]["kernel"], np.float32).T)
            sd[f"head.{idx}.bias"] = np.ascontiguousarray(
                np.asarray(params["head"][sub]["bias"], np.float32))
    return sd


_MAE_DENSE = ("decoder_embed", "decoder_pred")


def torch_to_jax_mae(sd: Mapping[str, Any]) -> dict[str, Any]:
    """MaeModel state dict (encoder.* + decoder.*) -> JAX-package tree
    {'encoder': ..., 'decoder': ...} (numpy leaves)."""
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    decoder = torch_to_jax_backbone({k: v for k, v in dec.items() if k.startswith("blocks.")})
    for k, raw in dec.items():
        v = _np(raw)
        sub, _, leaf = k.partition(".")
        if sub == "mask_token":
            decoder["mask_token"] = v
        elif sub in _MAE_DENSE:
            decoder.setdefault(sub, {})["kernel" if leaf == "weight" else "bias"] = (
                v.T if leaf == "weight" else v)
        elif sub == "decoder_norm":
            decoder.setdefault(sub, {})["scale" if leaf == "weight" else "bias"] = v
        elif sub != "blocks":
            raise KeyError(f"unrecognized MAE decoder key: {k}")
    return {"encoder": torch_to_jax_backbone(enc), "decoder": decoder}


def jax_to_torch_mae(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Inverse of :func:`torch_to_jax_mae`: the port's MaeModel state dict."""
    sd = {f"encoder.{k}": v for k, v in jax_to_torch_backbone(params["encoder"]).items()}
    dec = params["decoder"]
    blocks = {k: v for k, v in dec.items() if k.startswith("blocks_")}
    sd.update({f"decoder.{k}": v for k, v in jax_to_torch_backbone(blocks).items()})

    def f32(v: Any) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(v, dtype=np.float32))

    sd["decoder.mask_token"] = f32(dec["mask_token"])
    for sub in _MAE_DENSE:
        sd[f"decoder.{sub}.weight"] = f32(np.asarray(dec[sub]["kernel"]).T)
        sd[f"decoder.{sub}.bias"] = f32(dec[sub]["bias"])
    sd["decoder.decoder_norm.weight"] = f32(dec["decoder_norm"]["scale"])
    sd["decoder.decoder_norm.bias"] = f32(dec["decoder_norm"]["bias"])
    return sd


def jax_layout(name: str, ndim: int) -> tuple[int, ...]:
    """The permutation of the axes of the port's parameter *name* (of *ndim*
    axes) that gives its layout in the JAX package: ``(2, 3, 1, 0)`` for the
    patch embedding, a transpose for a dense weight or LoRA factor (every
    2-D ``*.weight``), the identity otherwise (tokens, positional tables,
    MoE expert stacks, 1-D parameters)."""
    if name.endswith("patch_embed.weight"):
        return (2, 3, 1, 0)
    if ndim == 2 and name.endswith(".weight"):
        return (1, 0)
    return tuple(range(ndim))
