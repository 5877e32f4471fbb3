"""Closed-loop embedding of CT series: a cohort of series held on the
device as uint16 canvases, embedded one series at a time, cycling through
the cohort, by the inner loop of the program's
``evaluation.embedder.embed_rows``: each batch of ``batch_size`` slices
through ``ops.augment.eval_transform`` and the ``zoo.hub.LoadedModel``
forward, its CLS copied to the host, the series' rows L2-normalised there.

A request is one series. Its latency runs from when it was due (the end
of the one before it) to when its embeddings are on the host. The series'
lengths are the mix's fixed set, in an order drawn from the seed, so every
seed does the same work; the pixels and the spacings come from the seed.

After the window, ``check_requests`` of the completed requests, the one
with the most slices among them and the others drawn from the seed, are
embedded again by the reference and compared slice by slice.

The mix's keys: ``lengths``, ``batch_size``, ``canvas``, ``pixel_range``,
``pixel_spacing_mm``, ``thickness_mm``, ``check_requests``,
``trace_requests``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch
from torch.profiler import record_function

from harness import compare, timing, trace, weights
from harness.drivers.common import Phases, free, sync
from harness.spec import Cell


class Driver:
    def __init__(self, cell: Cell, device: torch.device, seed: int):
        self.cell, self.device, self.seed = cell, device, seed
        self.mix = cell.mix
        self.model = dict(cell.config["model"])
        self.batch = int(self.mix["batch_size"])
        self.done: list[tuple[int, np.ndarray]] = []
        self.reference: Optional[dict[int, torch.Tensor]] = None
        self.request_index = 0

    def make_cohort(self) -> None:
        m, dev = self.mix, self.device
        order = weights.host_rng(self.seed, weights.ORDER).permutation(len(m["lengths"]))
        self.lengths = [int(m["lengths"][i]) for i in order]
        gen = weights.generator(self.seed, weights.PIXELS, dev)
        self.series = [weights.canvases(gen, n, m["canvas"], *m["pixel_range"], dev) for n in self.lengths]
        sp = weights.spacings(weights.generator(self.seed, weights.SPACING, dev), len(self.lengths),
                              tuple(m["pixel_spacing_mm"]), tuple(m["thickness_mm"]), dev)
        self.spacing = [sp[i].expand(n, 3).contiguous() for i, n in enumerate(self.lengths)]

    def setup(self) -> None:
        from dinox_torch.models.config import ModelConfig
        from dinox_torch.ops.augment import eval_transform
        from dinox_torch.zoo.hub import LoadedModel

        phase = Phases(self.device)
        self.eval_transform = eval_transform
        self.net = LoadedModel(ModelConfig.from_dict(self.model), device=self.device)
        phase("model")
        self.shapes = {n: tuple(p.shape) for n, p in self.net.named_parameters()}
        w0 = weights.make(self.shapes, self.seed, self.device)
        with torch.no_grad():
            for name, p in self.net.named_parameters():
                p.copy_(w0[name])
        del w0
        phase("weights")
        self.make_cohort()
        phase("cohort")
        # Warm up each batch shape the cohort sends: full batches and every tail.
        for rows in sorted({self.batch} | {n % self.batch for n in self.lengths} - {0}):
            self.embed_batch(self.series[0][:1].expand(rows, -1, -1, -1), self.spacing[0][:1].expand(rows, 3))
        phase("warm-up")
        phase.report()

    def embed_batch(self, pixels: torch.Tensor, spacing: torch.Tensor) -> np.ndarray:
        with record_function("bench.transform"):
            x = self.eval_transform(pixels, img_size=self.model["img_size"])
        with record_function("bench.forward"):
            tokens = self.net(x, spacing if self.model.get("scale_aware") else None)
        with record_function("bench.to_host"):
            return tokens[:, 0].float().cpu().numpy()

    def request(self) -> tuple[int, np.ndarray]:
        k = self.request_index % len(self.series)
        self.request_index += 1
        px, sp = self.series[k], self.spacing[k]
        with record_function("bench.request"):
            cls = np.concatenate([self.embed_batch(px[s:s + self.batch], sp[s:s + self.batch])
                                  for s in range(0, len(px), self.batch)])
            cls = cls / np.maximum(np.linalg.norm(cls, axis=-1, keepdims=True), 1e-12)
        return k, cls

    def window(self, seconds: float) -> dict[str, Any]:
        sync(self.device)
        latencies, slices = [], 0
        t0 = due = time.perf_counter()
        while not latencies or due - t0 < seconds:
            k, cls = self.request()
            end = time.perf_counter()
            latencies.append(end - due)
            self.done.append((k, cls))
            slices += len(cls)
            due = end
        elapsed = due - t0
        self.rate = timing.rate(slices, elapsed)
        failed = sum(1 for _, cls in self.done if not np.isfinite(cls).all())
        return {"metrics": {"embed_slices_per_s": self.rate,
                            "embed_request_p95_ms": 1e3 * timing.percentile(latencies, 95)},
                "attempted": len(latencies), "failed": failed, "window_s": elapsed}

    def traced(self) -> trace.Trace:
        """The profiler's trace of ``trace_requests`` more requests.
        ``traced`` lists their batches as (views, forward passes, backward
        passes): each series' full batches and its shorter last one."""
        n = int(self.mix["trace_requests"])
        lengths = [self.lengths[(self.request_index + i) % len(self.lengths)] for i in range(n)]
        self.traced_batches = [(min(self.batch, L - s), 1, 0) for L in lengths for s in range(0, L, self.batch)]
        return trace.capture(lambda: [self.request() for _ in range(int(self.mix["trace_requests"]))],
                             lambda: sync(self.device), self.device.type == "cuda")

    def release(self) -> None:
        del self.net
        free(self.device)

    # -- correctness ----------------------------------------------------------
    def sample(self) -> list[int]:
        """Indices into the completed requests: the longest, then others
        drawn from the seed."""
        n = min(int(self.mix["check_requests"]), len(self.done))
        longest = max(range(len(self.done)), key=lambda i: len(self.done[i][1]))
        rest = [i for i in weights.host_rng(self.seed, weights.SAMPLE).permutation(len(self.done))
                if i != longest]
        return [longest] + rest[:n - 1]

    def run_reference(self, mm=None) -> dict[int, torch.Tensor]:
        from reference import embed

        w0 = weights.make(self.shapes, self.seed, self.device)
        kw = {} if mm is None else {"mm": mm}
        sp = (lambda k: self.spacing[k]) if self.model.get("scale_aware") else (lambda k: None)
        ks = sorted({self.done[i][0] for i in self.picked})
        out = {k: embed.embed(self.series[k], sp(k), w0, self.model, **kw).cpu() for k in ks}
        del w0
        free(self.device)
        return out

    def check(self, kind: str = "program") -> dict[str, float]:
        """``emb_gap``, the largest distance between a compared slice's unit
        CLS and the reference's, of *kind*: ``program`` (the window's
        answers) or ``control`` (the reference in float8 in their place)."""
        if self.reference is None:
            self.picked = self.sample()
            self.reference = self.run_reference()
        if kind == "program":
            gaps = [compare.unit_gap(self.done[i][1], self.reference[self.done[i][0]]) for i in self.picked]
        elif kind == "control":
            from reference.lowp import mm_fp8
            low = self.run_reference(mm=mm_fp8)
            gaps = [compare.unit_gap(low[k], self.reference[k]) for k in low]
        else:
            raise ValueError(f"unknown check {kind!r}")
        return {"emb_gap": max(gaps)}
