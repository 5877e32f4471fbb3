"""Closed-loop DINO pretraining of a DINOv3-block model (RoPE, SwiGLU,
LayerScale): ``pretrain``'s driver with ``reference/dino_rope.py`` as the
reference, sized for a 1.7 B-parameter stage on one card.

What differs from ``pretrain``:

- the LayerScale gains (``*.gamma``) are drawn as a trained model's, mean 1
  with a spread of 0.02 (``harness.weights.scale`` would give them the
  spread about 0 of a bias, which leaves each residual branch at ~2% and
  the compared numbers with little of the block in them), in the program's
  weights and in the reference's alike;
- each leaf's change over the checked steps is kept on the host, and the
  reference's state is taken over in place with its first gradient on the
  host, so that the program's state, then the reference's, fit the card;
- the run stops at once, with a message, where the program has no
  DINOv3 block (``ModelConfig.block``): a program without it would build
  another model;
- the traced sub-window's launches of the RoPE and SwiGLU kernels, by the
  program's own counters (``ops.rope``, ``ops.swiglu``), go to standard
  error beside the count the traced work makes.

The mix's keys are ``pretrain``'s.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

import torch

from harness import weights
from harness.drivers import pretrain
from harness.drivers.common import Phases, free

GAIN = "gamma"


def make(shapes, seed: int, device, stream: int = weights.WEIGHTS) -> dict[str, torch.Tensor]:
    """``weights.make`` with the LayerScale gains about 1."""
    out = weights.make(shapes, seed, device, stream)
    for name, t in out.items():
        if name.rsplit(".", 1)[-1] == GAIN:
            t.add_(1.0)
    return out


class Driver(pretrain.Driver):
    def __init__(self, cell, device, seed):
        from dinox_torch.models.config import ModelConfig

        if "block" not in {f.name for f in dataclasses.fields(ModelConfig)}:
            raise SystemExit("the program has no DINOv3 block (ModelConfig.block): it cannot run this cell")
        super().__init__(cell, device, seed)

    def setup(self) -> None:
        from dinox_torch.train.state import create_train_state
        from dinox_torch.train.step import build_train_step

        phase = Phases(self.device)
        cfg = self.train_config()
        self.state = create_train_state(cfg, seed=0, device=self.device)
        phase("state")
        self.shapes = {n: tuple(p.shape) for n, p in self.state.student.named_parameters()}
        with torch.no_grad():
            for net, stream in ((self.state.student, weights.WEIGHTS), (self.state.teacher, weights.TEACHER)):
                w0 = make(self.shapes, self.seed, self.device, stream)
                for name, p in net.named_parameters():
                    p.copy_(w0[name])
                del w0
        self.state.step = self.start_step
        phase("weights")
        self.make_pool()
        phase("pool")
        self.step_fn = build_train_step(cfg, device=self.device)
        losses = []
        for n in range(max(pretrain.WARM_STEPS, self.check_steps)):
            losses.append(self.step())
            if n == 0:
                self.grad1 = self.first_gradient()
                self.first = {k: float(self.metrics[k]) for k in pretrain.STEP1 if k in self.metrics}
            if n + 1 == self.check_steps:
                self.change = self.leaf_changes(self.state.student, weights.WEIGHTS)
                self.teacher_change = self.leaf_changes(self.state.teacher, weights.TEACHER)
            phase(f"step{n + 1}")
        phase.report()
        self.losses = [float(x) for x in losses[:self.check_steps]]

    def traced(self):
        from dinox_torch.ops import rope, swiglu

        counters = (rope.rope_fwd, rope.rope_bwd, swiglu.swiglu_fwd, swiglu.swiglu_bwd)
        before = [c.launches for c in counters]
        tr = super().traced()
        got = [c.launches - b for c, b in zip(counters, before)]
        depth = self.model["depth"]
        fwd = sum(depth * f for _, f, _ in self.traced_batches)
        bwd = sum(depth * b for _, _, b in self.traced_batches)
        print(f"launch counters: rope {got[0]} forward, {got[1]} backward; swiglu {got[2]} forward, "
              f"{got[3]} backward; the traced work makes {fwd} and {bwd} of each", file=sys.stderr)
        return tr

    def leaf_changes(self, net: torch.nn.Module, stream: int) -> dict[str, torch.Tensor]:
        return self.changes({n: p.detach() for n, p in net.named_parameters()}, stream)

    def changes(self, final: dict[str, torch.Tensor], stream: int) -> dict[str, torch.Tensor]:
        """Each leaf of *final* less the seed's weights of *stream*, on the host."""
        w0 = make(self.shapes, self.seed, self.device, stream)
        out = {k: (final[k] - w0[k]).cpu() for k in self.shapes}
        del w0
        free(self.device)
        return out

    def run_reference(self, mm=None, half_batch: bool = False) -> dict[str, Any]:
        from reference import dino_rope

        batches = [(self.pixels[i], self.spacing[i]) for i in range(self.check_steps)]
        kw = {} if mm is None else {"mm": mm}
        out = dino_rope.train(make(self.shapes, self.seed, self.device),
                              make(self.shapes, self.seed, self.device, weights.TEACHER),
                              self.model, self.recipe, batches, start=self.start_step, half_batch=half_batch, **kw)
        student, teacher = out.pop("student"), out.pop("teacher")
        free(self.device)
        out["change"] = self.changes(student, weights.WEIGHTS)
        del student
        out["teacher_change"] = self.changes(teacher, weights.TEACHER)
        return out
