"""Closed-loop DINO pretraining, data-parallel over the mix's ``ranks``
processes, one card each: ``pretrain``'s driver on the program's
``(data)`` mesh (``parallel.mesh``), with NCCL between the cards.

The benchmark's process is rank 0. It starts ranks 1 to ``ranks - 1`` (this
file run as a script, one process per card, ``cuda:<rank>``) and joins
them in a process group over a TCP store on ``localhost`` (the program's
``parallel.mesh.init_distributed``): NCCL where every rank has a card of its
own, gloo where they share fewer cards (or the CPU). Every rank builds the
same state from the seed and makes its own pool: each micro-step's global
batch of ``ranks x batch_size`` canvases is drawn from the seed on the
rank's card and the rank keeps its rows (``parallel.mesh.batch_rows``). The
program's step takes each rank's rows, draws the views at the global shape
and all-reduces the gradients (``dinox.train.reduce``).

Rank 0 leads: before each step of the window and of the traced sub-window
it sends the others a word on a gloo group of the hosts (step, or leave),
so every rank runs the same steps with no synchronisation of the devices;
a watchdog thread ends rank 0 at once, with a message, when another rank
ends early, and each other rank ends when rank 0 is gone, so that no
collective waits on a rank that is gone;
the window's rate is rank 0's, in global slices per second. After the
window rank 0 tells the others to leave, all leave the process group
together, rank 0 waits for the other processes to end, and alone
compares the first steps with the reference: ``reference/dino.py``'s step
on the global batch (``ranks x batch_size`` slices a micro-step), each
block recomputed in the backward so that it fits one card. Besides
``pretrain``'s numbers it gives ``grad_dir_gap``, which sees the exchange
between the cards: the worst leaf's distance between the program's first
gradient (rank 0's, as its optimizer holds it) and the reference's, over
the larger of that leaf's and the median leaf's reference norm. The other
numbers compare sizes, and with fresh AdamW moments the first steps move
each element by about lr * sign(g) whichever rows g came from.

The mix's keys: ``pretrain``'s and ``ranks``; ``fault`` is for readings
alone: ``"unreduced"`` leaves out the gradients' all-reduce on every rank
(each rank then steps on its own rows' gradient), the fault that
``grad_dir_gap`` is there to catch.
"""

from __future__ import annotations

import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch

if __name__ == "__main__":  # a rank's process: the benchmark's folder and the checkout on the path
    sys.path[:0] = [str(Path(__file__).resolve().parents[2]), str(Path(__file__).resolve().parents[3])]

from harness import weights
from harness.drivers import pretrain
from harness.drivers.common import Phases, free, sync
from harness.spec import Cell

STEP, LEAVE = 1, 0
RANK_ARG = 4  # a rank process's argv: python, this file, cell, seed, rank, port, device
JOIN_S = 300.0  # the longest rank 0 waits for the others to leave


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Driver(pretrain.Driver):
    def __init__(self, cell: Cell, device: torch.device, seed: int, rank: int = 0, port: Optional[int] = None):
        super().__init__(cell, device, seed)
        self.world = int(self.mix["ranks"])
        self.rank = rank
        if self.mix.get("fault") not in (None, "unreduced"):
            raise ValueError(f"unknown fault {self.mix['fault']!r}")
        self.global_batch = self.batch * self.world
        self.slices_per_step = self.global_batch * self.accum
        self.procs: list[subprocess.Popen] = []
        if rank == 0:
            port = free_port()
            script = Path(__file__).resolve()
            for r in range(1, self.world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(script), cell.name, str(seed), str(r), str(port), device.type],
                    cwd=str(script.parents[3]), stdout=sys.stderr))
            self.watching = True
            threading.Thread(target=self.watch, daemon=True).start()
        self.join(port)

    def watch(self) -> None:
        """Rank 0's watchdog: end the process where another rank ended early."""
        while self.watching:
            down = [(p.args[RANK_ARG], p.poll()) for p in self.procs if p.poll() not in (None, 0)]
            if down and self.watching:
                print(f"rank(s) {down} ended early", file=sys.stderr, flush=True)
                os._exit(1)
            time.sleep(0.5)

    # -- the process group ------------------------------------------------------
    def join(self, port: int) -> None:
        import torch.distributed as dist
        from dinox_torch.parallel.mesh import init_distributed, make_mesh

        dev = self.device
        if dev.type == "cuda":
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        shared = dev.type != "cuda" or torch.cuda.device_count() < self.world
        init_distributed(f"localhost:{port}", self.world, self.rank, backend="gloo" if shared else None,
                         device=dev)
        self.device = dev
        self.mesh = make_mesh(device=dev)
        self.control = dist.new_group(backend="gloo")

    def send(self, word: int) -> int:
        """Rank 0's *word* to every rank (a host broadcast); returns it."""
        import torch.distributed as dist

        t = torch.tensor([word], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.control)
        return int(t.item())

    # -- inputs and the program -------------------------------------------------
    def global_pool(self, steps: int, rows: Optional[tuple[int, int]] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(pixels (steps, accum, rows, ...), spacing (steps, accum, rows, 3))
        of the pool's first *steps* steps, drawn on this rank's device one
        micro-step's global batch at a time and cut to *rows* ``(lo, hi)``
        (every row where None)."""
        m, dev = self.mix, self.device
        lo, hi = rows or (0, self.global_batch)
        gen = weights.generator(self.seed, weights.PIXELS, dev)
        pixels = torch.empty((steps, self.accum, hi - lo, m["canvas"], m["canvas"], 3),
                             dtype=torch.uint16, device=dev)
        for s in range(steps):
            for a in range(self.accum):
                pixels[s, a] = weights.canvases(gen, self.global_batch, m["canvas"], *m["pixel_range"], dev)[lo:hi]
        sp = weights.spacings(weights.generator(self.seed, weights.SPACING, dev),
                              int(m["pool_steps"]) * self.accum * self.global_batch,
                              tuple(m["pixel_spacing_mm"]), tuple(m["thickness_mm"]), dev)
        return pixels, sp.view(-1, self.accum, self.global_batch, 3)[:steps, :, lo:hi].contiguous()

    def make_pool(self) -> None:
        from dinox_torch.parallel.mesh import batch_rows

        self.pixels, self.spacing = self.global_pool(int(self.mix["pool_steps"]),
                                                     batch_rows(self.mesh, self.global_batch))

    def setup(self) -> None:
        from dinox_torch.train.state import create_train_state
        from dinox_torch.train.step import build_train_step

        phase = Phases(self.device)
        cfg = self.train_config().replace(batch_size=self.global_batch)
        self.state = create_train_state(cfg, seed=0, device=self.device, mesh=self.mesh)
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
        if self.mix.get("fault") == "unreduced":
            from dinox_torch.train import step as program_step
            program_step.all_reduce_bucket = lambda tensors, group, op="sum": list(tensors)
        self.step_fn = build_train_step(cfg, device=self.device, mesh=self.mesh)
        losses = []
        for n in range(max(pretrain.WARM_STEPS, self.check_steps)):
            losses.append(self.step())
            if n == 0 and self.rank == 0:
                self.grad1 = self.first_gradient()
                self.first = {k: float(self.metrics[k]) for k in pretrain.STEP1 if k in self.metrics}
            if n + 1 == self.check_steps and self.rank == 0:
                self.change = self.leaf_changes(self.state.student, weights.WEIGHTS)
                self.teacher_change = self.leaf_changes(self.state.teacher, weights.TEACHER)
            phase(f"step{n + 1}")
        if self.rank == 0:
            phase.report()
        self.losses = [float(x) for x in losses[:self.check_steps]]

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float) -> dict[str, Any]:
        sync(self.device)
        losses = []
        t0 = time.perf_counter()
        while not losses or time.perf_counter() - t0 < seconds:
            self.send(STEP)
            losses.append(self.step())
        sync(self.device)
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        self.rate = len(losses) * self.slices_per_step / elapsed
        return {"metrics": {"train_slices_per_s": self.rate}, "attempted": len(losses), "failed": failed,
                "window_s": elapsed}

    def traced(self):
        """``pretrain``'s traced steps on rank 0, each announced to the others."""
        step = self.step

        def announced() -> torch.Tensor:
            self.send(STEP)
            return step()

        self.step = announced
        try:
            return super().traced()
        finally:
            del self.step

    def follow(self) -> None:
        """The other ranks' part after set-up: a step for each word from rank 0."""
        while self.send(LEAVE) == STEP:
            self.step()

    def release(self) -> None:
        """Every rank leaves the process group at once (NCCL's teardown waits
        for all of them, so rank 0 may not wait for the others first); then
        rank 0 waits for the other processes to end."""
        import torch.distributed as dist

        if self.rank == 0:
            self.send(LEAVE)
        del self.state, self.step_fn
        sync(self.device)
        dist.destroy_process_group()
        self.watching = False
        deadline = time.monotonic() + JOIN_S
        for p in self.procs:
            try:
                code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                code = "killed"
            if code != 0:
                raise RuntimeError(f"rank {p.args[RANK_ARG]} ended with {code}")
        free(self.device)

    # -- correctness --------------------------------------------------------------
    def first_gradient(self) -> dict[str, torch.Tensor]:
        """Each leaf's first gradient as the optimizer holds it (AdamW's
        first moment after one step over ``1 - b1``), on the host."""
        opt = self.state.optimizer
        out = {}
        for group in opt.param_groups:
            for p in group["params"]:
                moment = opt.state.get(p, {}).get("exp_avg")
                out[id(p)] = (torch.zeros(p.shape) if moment is None
                              else moment.float().cpu() / (1.0 - group["betas"][0]))
        return {n: out[id(p)] for n, p in self.state.student.named_parameters()}

    def numbers(self, got: dict[str, Any]) -> dict[str, Any]:
        """``pretrain``'s numbers and ``grad_dir_gap``."""
        ref = {k: g.cpu() for k, g in self.reference["grad1"].items()}
        floor = statistics.median(float(g.norm()) for g in ref.values())
        gaps = {k: float((got["grad1"][k].cpu().float() - g).norm()) / max(float(g.norm()), floor)
                for k, g in ref.items()}
        leaf = max(gaps, key=gaps.get)
        return {**super().numbers(got), "grad_dir_gap": gaps[leaf], "grad_dir_leaf": leaf}

    def run_reference(self, mm=None, half_batch: bool = False) -> dict[str, Any]:
        from reference import dino

        pixels, spacing = self.global_pool(self.check_steps)
        w0 = weights.make(self.shapes, self.seed, self.device)
        t0 = weights.make(self.shapes, self.seed, self.device, weights.TEACHER)
        kw = {} if mm is None else {"mm": mm}
        out = dino.train(w0, t0, {**self.model, "use_grad_checkpoint": True}, self.recipe,
                         [(pixels[i], spacing[i]) for i in range(self.check_steps)], start=self.start_step,
                         half_batch=half_batch, **kw)
        del w0, t0, pixels, spacing
        free(self.device)
        return out


def worker(argv: list[str]) -> int:
    """Rank *rank* of *cell* at *seed*: ``name seed rank port device``."""
    from harness import spec

    name, seed, rank, port, device = argv
    parent = os.getppid()

    def orphaned() -> None:  # rank 0 gone: end here too, rather than wait in a collective
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    cell = spec.find_cell(name)
    drv = Driver(cell, torch.device(device), int(seed), rank=int(rank), port=int(port))
    drv.setup()
    drv.follow()
    drv.release()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(2)
    sys.exit(worker(sys.argv[1:]))
