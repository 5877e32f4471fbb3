"""Closed-loop DINO pretraining: back-to-back optimizer steps of the
program's ``train.step.build_train_step`` over a pool of optimizer-step
batches made on the device from the seed and cycled, with no
synchronisation between steps.

Set-up builds one training state, puts the seed's weights in the student
and weights of their own stream in the teacher (so the Gram term and the
EMA have something to do), sets its step to the end of the recipe's
warm-up (the learning rate at its peak), and drives it through the first
``check_steps`` steps (and up to three in all) through the window's own
call and feed. It reads each step's loss, the first step's KoLeo and Gram
terms, the first gradient as the optimizer holds it (AdamW's first moment
after one step over ``1 - b1``) and each leaf's change, the student's and
the teacher's, after ``check_steps`` steps. The window then goes on with
the same state. The reference follows those first steps from the same
weights, step and batches.

The mix's keys: ``batch_size``, ``accumulation_steps``, ``pool_steps``,
``canvas``, ``pixel_range``, ``pixel_spacing_mm``, ``thickness_mm``,
``check_steps`` and ``trace_steps``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch
from torch.profiler import record_function

from harness import compare, trace, weights
from harness.drivers.common import Phases, free, sync
from harness.spec import Cell

WARM_STEPS = 3
STEP1 = ("loss_koleo", "loss_gram")
TRAIN_KEYS = ("lr", "min_lr", "warmup_steps", "max_steps", "weight_decay", "ema", "teacher_temp",
              "student_temp", "center_momentum", "gram_weight", "koleo_weight", "train_seed",
              "mu_dtype", "nu_dtype")


class Driver:
    def __init__(self, cell: Cell, device: torch.device, seed: int):
        self.cell, self.device, self.seed = cell, device, seed
        self.mix = cell.mix
        self.model = dict(cell.config["model"])
        self.recipe = cell.config["recipe"]
        self.batch = int(self.mix["batch_size"])
        self.accum = int(self.mix["accumulation_steps"])
        self.check_steps = int(self.mix["check_steps"])
        self.slices_per_step = self.batch * self.accum
        self.start_step = int(self.recipe["warmup_steps"])
        self.reference: Optional[dict[str, Any]] = None
        self.step_index = 0

    # -- inputs ---------------------------------------------------------------
    def make_pool(self) -> None:
        m, dev = self.mix, self.device
        gen = weights.generator(self.seed, weights.PIXELS, dev)
        steps = int(m["pool_steps"])
        self.pixels = torch.empty((steps, self.accum, self.batch, m["canvas"], m["canvas"], 3),
                                  dtype=torch.uint16, device=dev)
        for s in range(steps):
            for a in range(self.accum):
                self.pixels[s, a] = weights.canvases(gen, self.batch, m["canvas"], *m["pixel_range"], dev)
        sp = weights.spacings(weights.generator(self.seed, weights.SPACING, dev), steps * self.accum * self.batch,
                              tuple(m["pixel_spacing_mm"]), tuple(m["thickness_mm"]), dev)
        self.spacing = sp.view(steps, self.accum, self.batch, 3)

    # -- the program ----------------------------------------------------------
    def train_config(self):
        from dinox_torch.models.config import ModelConfig
        from dinox_torch.train.state import TrainConfig

        r = self.recipe
        return TrainConfig(model=ModelConfig.from_dict(self.model), img_size=self.model["img_size"],
                           batch_size=self.batch, accumulation_steps=self.accum,
                           crop_scale_min=r["crop_scale"][0], crop_scale_max=r["crop_scale"][1],
                           **{k: r[k] for k in TRAIN_KEYS})

    def step(self) -> torch.Tensor:
        i = self.step_index % self.pixels.shape[0]
        with record_function("bench.step"):
            self.state, self.metrics = self.step_fn(self.state, self.pixels[i], self.spacing[i])
        self.step_index += 1
        return self.metrics["loss"]

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
                w0 = weights.make(self.shapes, self.seed, self.device, stream)
                for name, p in net.named_parameters():
                    p.copy_(w0[name])
                del w0
        self.state.step = self.start_step
        phase("weights")
        self.make_pool()
        phase("pool")
        self.step_fn = build_train_step(cfg, device=self.device)
        losses = []
        for n in range(max(WARM_STEPS, self.check_steps)):
            losses.append(self.step())
            if n == 0:
                self.grad1 = self.first_gradient()
                self.first = {k: float(self.metrics[k]) for k in STEP1 if k in self.metrics}
            if n + 1 == self.check_steps:
                self.change = self.leaf_changes(self.state.student, weights.WEIGHTS)
                self.teacher_change = self.leaf_changes(self.state.teacher, weights.TEACHER)
            phase(f"step{n + 1}")
        phase.report()
        self.losses = [float(x) for x in losses[:self.check_steps]]

    def first_gradient(self) -> dict[str, float]:
        opt = self.state.optimizer
        out = {}
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                moment = opt.state.get(p, {}).get("exp_avg")
                out[id(p)] = 0.0 if moment is None else float(moment.float().norm()) / (1.0 - b1)
        return {n: out[id(p)] for n, p in self.state.student.named_parameters()}

    def leaf_changes(self, net: torch.nn.Module, stream: int) -> dict[str, torch.Tensor]:
        w0 = weights.make(self.shapes, self.seed, self.device, stream)
        out = {n: p.detach() - w0[n] for n, p in net.named_parameters()}
        del w0
        return out

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> dict[str, Any]:
        sync(self.device)
        losses = []
        t0 = time.perf_counter()
        while not losses or time.perf_counter() - t0 < seconds:
            losses.append(self.step())
        sync(self.device)
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        self.rate = len(losses) * self.slices_per_step / elapsed
        return {"metrics": {"train_slices_per_s": self.rate}, "attempted": len(losses), "failed": failed,
                "window_s": elapsed}

    def traced(self) -> trace.Trace:
        """The profiler's trace of ``trace_steps`` more steps. ``traced``
        lists their batches as (views, forward passes, backward passes):
        each micro-step's two views of ``batch_size`` rows through the
        student and the teacher, and again through the student where the
        configuration recomputes under checkpointing."""
        passes = 3 if self.model.get("use_grad_checkpoint") else 2
        self.traced_batches = [(2 * self.batch, passes, 1)] * (int(self.mix["trace_steps"]) * self.accum)
        return trace.capture(lambda: [self.step() for _ in range(int(self.mix["trace_steps"]))],
                             lambda: sync(self.device), self.device.type == "cuda")

    def release(self) -> None:
        del self.state, self.step_fn
        free(self.device)

    # -- correctness ----------------------------------------------------------
    def run_reference(self, mm=None, half_batch: bool = False) -> dict[str, Any]:
        from reference import dino

        w0 = weights.make(self.shapes, self.seed, self.device)
        t0 = weights.make(self.shapes, self.seed, self.device, weights.TEACHER)
        batches = [(self.pixels[i], self.spacing[i]) for i in range(self.check_steps)]
        kw = {} if mm is None else {"mm": mm}
        out = dino.train(w0, t0, self.model, self.recipe, batches, start=self.start_step,
                         half_batch=half_batch, **kw)
        del w0, t0
        free(self.device)
        return out

    def numbers(self, got: dict[str, Any]) -> dict[str, Any]:
        """``loss_koleo_gap`` and ``loss_gram_gap``: the relative gaps of
        the first step's KoLeo and Gram terms (each the mean over its
        micro-batches), smooth functions of the first forwards, the
        student's and the teacher's. ``update_gap`` and ``teacher_gap``:
        the worst leaf's change over the checked steps, the student's and
        the teacher's (the EMA). ``loss_gap``, the worst step's loss, and
        ``grad_gap``, the worst leaf's first gradient norm, swing from seed
        to seed with the sharpened teacher target; the limits file says
        which numbers are compared."""
        ref = self.reference
        grad = {k: float(g.norm()) for k, g in ref["grad1"].items()}
        got_grad = {k: g if isinstance(g, float) else float(g.norm()) for k, g in got["grad1"].items()}
        grad_gap, grad_leaf = compare.worst_leaf(got_grad, grad)
        update_gap, update_leaf = compare.worst_leaf(compare.moving_norms(got["change"], ref["grad1"]),
                                                     compare.moving_norms(ref["change"], ref["grad1"]))
        teacher_gap, teacher_leaf = compare.worst_leaf(
            {k: float(v.norm()) for k, v in got["teacher_change"].items()},
            {k: float(v.norm()) for k, v in ref["teacher_change"].items()})
        first = {k: abs(got["first"].get(k, float("nan")) - ref["first"][k]) / abs(ref["first"][k]) for k in STEP1}
        return {"loss_koleo_gap": first["loss_koleo"], "loss_gram_gap": first["loss_gram"],
                "update_gap": update_gap, "update_leaf": update_leaf,
                "teacher_gap": teacher_gap, "teacher_leaf": teacher_leaf,
                "grad_gap": grad_gap, "grad_leaf": grad_leaf,
                "loss_gap": compare.loss_gap(got["losses"], ref["losses"])}

    def check(self, kind: str = "program") -> dict[str, float]:
        """The numbers of *kind*: ``program`` (the window's path against
        the reference), ``control`` (the reference in float8 in its place)
        or ``half_batch`` (the reference with half of each micro-batch left
        out in its place)."""
        if self.reference is None:
            self.reference = self.run_reference()
        if kind == "program":
            got = {"losses": self.losses, "grad1": self.grad1, "change": self.change, "first": self.first,
                   "teacher_change": self.teacher_change}
        elif kind == "control":
            from reference.lowp import mm_fp8
            got = self.run_reference(mm=mm_fp8)
        elif kind == "half_batch":
            got = self.run_reference(half_batch=True)
        else:
            raise ValueError(f"unknown check {kind!r}")
        return self.numbers(got)
