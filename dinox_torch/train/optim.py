"""Adam optimizers with low-precision or factored moment storage: the
port's ``_scale_by_adam_lowp`` and ``_scale_by_adam_factored``
(``dinox_tpu.train.state``), and optax's ``adamw(mu_dtype=...)``.

Both are ``torch.optim.Optimizer`` s with the JAX chain's update: Adam's
bias-corrected step (b1 0.9, b2 0.999, eps 1e-8; ``c_t = 1 - b^t`` in
float32), plus ``weight_decay * p`` (decoupled, on every parameter), times
the group's LR:

    step = (mu / c1) / (sqrt(nu / c2) + eps)
    p   <- p - lr * (step + weight_decay * p)

The moment arithmetic runs in float32 and only the stored state is cast.
Each parameter is updated on its own, so the float32 working copies of its
moments live for one tensor at a time: one multi-tensor pass over every
parameter would hold float32 copies of all the moments at once (7.7 GB at
ViT-G), which is the memory these optimizers exist to save.

* :class:`AdamLowp` stores ``exp_avg`` in ``mu_dtype`` and ``exp_avg_sq``
  in ``nu_dtype``. With ``optax_mu=True`` it is optax's
  ``adamw(mu_dtype=...)`` (the JAX package's choice when only ``mu_dtype``
  is low): there ``b1 * mu`` multiplies the stored moment by b1 *rounded to
  mu_dtype* (JAX's weak-typed scalar takes the array's dtype), and nu stays
  float32.
* :class:`AdamFactored` stores ``exp_avg`` in ``mu_dtype`` and, for a
  parameter of two or more axes, Adafactor's rank-1 factors of nu: the
  row and column EMAs of g^2 over the trailing two axes, recombined as
  ``v_ij = r_i c_j / mean(r)``. The axes are those of the parameter's
  *JAX-package layout* (``zoo.interop.jax_layout``): the port keeps
  ``(out, in)`` dense weights and a ``(D, 3, p, p)`` patch embedding where
  JAX keeps ``(in, out)`` and ``(p, p, 3, D)``, and factoring other axes
  would compute another approximation. So ``exp_avg_sq_r`` and
  ``exp_avg_sq_c`` are JAX's ``r`` and ``c`` as they are, in JAX's shapes
  (for a dense weight the port's rows are JAX's columns: its ``r`` has the
  length of the *input* axis). A 1-D parameter keeps a full float32
  ``exp_avg_sq``. On a mesh that cuts a parameter (``parallel.mesh``;
  :meth:`AdamFactored.cut_axis`), each statistic taken over the cut axis is
  the mean of the ranks' means over the group that holds the shards (the
  whole axis's mean, as GSPMD computes it in the JAX package): ``r`` when
  the cut axis is the layout's last, ``c`` and ``mean(r)`` when it is the
  one before; a cut of a leading axis (an expert stack's) needs nothing.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from dinox_torch.parallel.collectives import all_reduce

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta ** count`` in float32, as the JAX package computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


class _DecoupledAdam(torch.optim.Optimizer):
    """The update shared by both optimizers; subclasses give the step."""

    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    def _adam_step(self, p: torch.Tensor, g: torch.Tensor, state: dict, group: dict,
                   count: int) -> torch.Tensor:
        raise NotImplementedError

    def state_dtype(self, key: str) -> Optional[torch.dtype]:
        """The dtype a state entry named *key* is stored in (None: as loaded)."""
        return None

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    self._init_state(p, state)
                state["step"] += 1
                count = int(state["step"].item())
                step = self._adam_step(p, p.grad.float(), state, group, count)
                step.add_(p, alpha=group["weight_decay"])
                p.add_(step, alpha=-group["lr"])
        return loss

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        raise NotImplementedError


class AdamLowp(_DecoupledAdam):
    """Adam with ``exp_avg`` stored in *mu_dtype* and ``exp_avg_sq`` in
    *nu_dtype* (see the module docstring; *optax_mu* is optax's
    ``adamw(mu_dtype=...)``)."""

    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32, nu_dtype: torch.dtype = torch.float32,
                 optax_mu: bool = False):
        self.mu_dtype, self.nu_dtype, self.optax_mu = mu_dtype, nu_dtype, optax_mu
        super().__init__(params, lr, betas, eps, weight_decay)

    def state_dtype(self, key: str) -> Optional[torch.dtype]:
        return {"exp_avg": self.mu_dtype, "exp_avg_sq": self.nu_dtype}.get(key)

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
        state["exp_avg_sq"] = torch.zeros_like(p, dtype=self.nu_dtype)

    def _adam_step(self, p, g, state, group, count):
        b1, b2 = group["betas"]
        mu, nu = state["exp_avg"], state["exp_avg_sq"]
        decay1 = float(torch.tensor(b1, dtype=mu.dtype)) if self.optax_mu else b1
        mu_f = mu.float().mul_(decay1).add_(g, alpha=1.0 - b1)
        nu_f = nu.float().mul_(b2).addcmul_(g, g, value=1.0 - b2)
        step = mu_f / _bias_correction(b1, count)
        step.div_((nu_f / _bias_correction(b2, count)).sqrt_().add_(group["eps"]))
        mu.copy_(mu_f)
        nu.copy_(nu_f)
        return step


class AdamFactored(_DecoupledAdam):
    """Adam with ``exp_avg`` in *mu_dtype* and nu stored as Adafactor's
    rank-1 factors over the trailing two axes of each parameter's JAX
    layout: *layouts* maps a parameter to the permutation of its axes that
    gives that layout (identity when absent)."""

    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32,
                 layouts: Optional[dict[torch.Tensor, Sequence[int]]] = None):
        self.mu_dtype = mu_dtype
        self.layouts = {id(p): tuple(perm) for p, perm in (layouts or {}).items()}
        self.cuts: dict[int, tuple[int, object]] = {}  # id(p) -> (layout axis from the end, group)
        super().__init__(params, lr, betas, eps, weight_decay)

    def cut_axis(self, p: torch.Tensor, axis: int, group) -> None:
        """Note that *p* holds this rank's shard of its axis *axis* (the
        port's axis), cut over the process group *group*."""
        perm = self._perm(p)
        self.cuts[id(p)] = (perm.index(axis) - len(perm), group)

    def state_dtype(self, key: str) -> Optional[torch.dtype]:
        return self.mu_dtype if key == "exp_avg" else torch.float32

    def _perm(self, p: torch.Tensor) -> tuple[int, ...]:
        return self.layouts.get(id(p), tuple(range(p.ndim)))

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
        if p.ndim < 2:
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            return
        shape = tuple(p.shape[i] for i in self._perm(p))
        state["exp_avg_sq_r"] = torch.zeros(shape[:-1], dtype=torch.float32, device=p.device)
        state["exp_avg_sq_c"] = torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                            device=p.device)

    def _adam_step(self, p, g, state, group, count):
        b1, b2 = group["betas"]
        mu = state["exp_avg"]
        mu_f = mu.float().mul_(b1).add_(g, alpha=1.0 - b1)
        g2 = g * g
        if p.ndim < 2:
            nu_f = state["exp_avg_sq"].mul_(b2).add_(g2, alpha=1.0 - b2).clone()
        else:
            perm = self._perm(p)
            g2 = g2.permute(perm)
            at, shards = self.cuts.get(id(p), (None, None))
            rows, cols = g2.mean(dim=-1), g2.mean(dim=-2)
            if at == -1:
                rows = all_reduce(rows, shards, "mean")
            elif at == -2:
                cols = all_reduce(cols, shards, "mean")
            r = state["exp_avg_sq_r"].mul_(b2).add_(rows, alpha=1.0 - b2)
            c = state["exp_avg_sq_c"].mul_(b2).add_(cols, alpha=1.0 - b2)
            denom = r.mean(dim=-1, keepdim=True)
            if at == -2:
                denom = all_reduce(denom, shards, "mean")
            denom = denom.clamp_min(1e-30)
            nu_f = (r[..., :, None] * (c / denom)[..., None, :]).permute(tuple(np.argsort(perm)))
        step = mu_f / _bias_correction(b1, count)
        step.div_((nu_f / _bias_correction(b2, count)).sqrt_().add_(group["eps"]))
        mu.copy_(mu_f)
        return step


def build_adam(groups: Iterable[dict], lr: float, weight_decay: float, mu_dtype: str,
               nu_dtype: str, factored_nu: bool,
               layouts: Optional[dict[torch.Tensor, Sequence[int]]] = None
               ) -> torch.optim.Optimizer:
    """The optimizer the JAX package's ``make_optimizer`` picks for these
    moment options: ``torch.optim.AdamW`` for float32 moments, optax's
    ``adamw(mu_dtype)`` for a low mu alone, :class:`AdamLowp` for a low nu,
    :class:`AdamFactored` for ``factored_nu``."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    mu, nu = DTYPES[mu_dtype], DTYPES[nu_dtype]
    if factored_nu:
        return AdamFactored(groups, mu_dtype=mu, layouts=layouts, **kw)
    if mu == nu == torch.float32:
        return torch.optim.AdamW(groups, **kw)
    return AdamLowp(groups, mu_dtype=mu, nu_dtype=nu, optax_mu=nu == torch.float32, **kw)
