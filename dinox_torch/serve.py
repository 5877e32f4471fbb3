"""Embedding server: HTTP front-end over the port's zoo inference API.

The twin of ``scripts/serve.py``: load once, pad requests to fixed batch
buckets, warm every bucket at startup, and fuse concurrent requests into one
forward on a single dispatcher thread. Stdlib HTTP (ThreadingHTTPServer).

API:
  GET  /healthz          -> {"status": "ok", "model": {...}, "buckets": [...], "stats": {...}}
  POST /embed            -> {"embeddings": [[...], ...], "dim": D, "latency_ms": t}
    body: {"images": [[[...HU floats...]], ...],   # (H, W) each
           "spacings": [[sx, sy, sz], ...],        # required if scale-aware
           "input_format": "hu_float"|"hu16_png"|"windowed_float",
           "hu_level": 40.0, "hu_width": 400.0}

Usage:
    python -m dinox_torch.serve --backbone path/to/hub_dir --port 8000 \
        --buckets 1 8 32 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dinox_torch.zoo.encode import _preprocess
from dinox_torch.zoo.hub import load_model


class _Work:
    """One enqueued embed request: preprocessed pixels + spacing + a Future
    the dispatcher resolves with this request's slice of the fused batch."""

    __slots__ = ("xs", "sp", "future")

    def __init__(self, xs, sp):
        self.xs = xs
        self.sp = sp
        self.future: Future = Future()


class EmbedService:
    """Bucketed batch embedding around a LoadedModel, with cross-request
    micro-batching.

    All forwards run on ONE dispatcher thread fed by a queue: when a request
    arrives, the dispatcher keeps draining the queue for up to
    ``batch_window_ms`` (or until the largest bucket is full) and fuses the
    coalesced images into a single forward. Requests are padded up to the
    smallest bucket that fits; oversize batches are chunked by the largest
    bucket.
    """

    def __init__(self, backbone: str, buckets: list[int],
                 batch_window_ms: float = 6.0, fused_attn: bool = False,
                 device: str | torch.device | None = None):
        if fused_attn:
            raise NotImplementedError(
                "fused_attn (the fused attention half-block kernel) is not ported to dinox_torch yet")
        self.model = load_model(backbone, device=device)
        self.buckets = sorted(set(buckets))
        self._window = batch_window_ms / 1000.0
        self.stats = {"requests": 0, "forwards": 0, "images": 0}
        self._queue: queue.Queue = queue.Queue()
        self._closing = False
        # Serializes enqueue vs close(): without it a request that passed the
        # _closing check could land BEHIND the shutdown sentinel and its
        # handler thread would block forever on future.result().
        self._submit_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="dinox-torch-serve-dispatch", daemon=True
        )
        self._dispatcher.start()

    def close(self) -> None:
        """Stop the dispatcher (pending requests are still served first).
        The sentinel is enqueued under the submit lock, so it is the LAST
        queue item and every enqueued request resolves."""
        with self._submit_lock:
            self._closing = True
            self._queue.put(None)
        self._dispatcher.join(timeout=30)

    def warmup(self) -> None:
        for b in self.buckets:
            x = np.zeros((b, self.model.img_size, self.model.img_size, 3), np.float32)
            sp = np.ones((b, 3), np.float32) if self.model.scale_aware else None
            t0 = time.perf_counter()
            self._forward(x, sp)
            print(f"warmup bucket={b}: {time.perf_counter() - t0:.1f}s", flush=True)

    def _forward(self, x: np.ndarray, spacing) -> np.ndarray:
        cls = self.model(x, spacing)[:, 0, :]
        cls = cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return cls.cpu().numpy()

    def embed(self, images, spacings, input_format="hu_float",
              hu_level=40.0, hu_width=400.0) -> np.ndarray:
        if self.model.scale_aware and spacings is None:
            raise ValueError("model is scale-aware: 'spacings' is required")
        xs = np.stack([
            _preprocess(np.asarray(img, np.float32), self.model.img_size,
                        input_format, hu_level, hu_width)
            for img in images
        ])
        sp = np.asarray(spacings, np.float32) if self.model.scale_aware else None
        work = _Work(xs, sp)
        with self._submit_lock:
            if self._closing:
                raise RuntimeError("service is shut down")
            self._queue.put(work)
        return work.future.result()

    # -- dispatcher ---------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._closing = True
                return
            batch = [item]
            total = item.xs.shape[0]
            deadline = time.monotonic() + self._window
            while total < self.buckets[-1]:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is None:  # close(): serve what we have, then exit
                    self._closing = True
                    break
                batch.append(nxt)
                total += nxt.xs.shape[0]
            self._run_batch(batch)
            if self._closing:
                return

    def _run_batch(self, batch: list[_Work]) -> None:
        try:
            xs = np.concatenate([w.xs for w in batch], axis=0)
            sp = (np.concatenate([w.sp for w in batch], axis=0)
                  if batch[0].sp is not None else None)
            n = xs.shape[0]
            out, start = [], 0
            while start < n:
                remaining = n - start
                bucket = next((b for b in self.buckets if b >= remaining), self.buckets[-1])
                take = min(bucket, remaining)
                xb = np.zeros((bucket,) + xs.shape[1:], np.float32)
                xb[:take] = xs[start:start + take]
                spb = None
                if sp is not None:
                    spb = np.ones((bucket, 3), np.float32)
                    spb[:take] = sp[start:start + take]
                out.append(self._forward(xb, spb)[:take])
                start += take
                self.stats["forwards"] += 1
            emb = np.concatenate(out, axis=0)
            self.stats["requests"] += len(batch)
            self.stats["images"] += n
            pos = 0
            for w in batch:
                k = w.xs.shape[0]
                w.future.set_result(emb[pos:pos + k])
                pos += k
        except BaseException as e:  # noqa: BLE001 — propagate to every waiter
            for w in batch:
                if not w.future.done():
                    w.future.set_exception(e)


def make_handler(service: EmbedService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log -> stdout kv
            print(f"http {self.command} {self.path} {args[1] if len(args) > 1 else ''}",
                  flush=True)

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            m = service.model
            self._json(200, {
                "status": "ok",
                "model": {"dim": m.dim, "img_size": m.img_size,
                          "scale_aware": m.scale_aware},
                "buckets": service.buckets,
                "stats": dict(service.stats),
            })

        def do_POST(self):
            if self.path != "/embed":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                t0 = time.perf_counter()
                emb = service.embed(
                    req["images"], req.get("spacings"),
                    input_format=req.get("input_format", "hu_float"),
                    hu_level=float(req.get("hu_level", 40.0)),
                    hu_width=float(req.get("hu_width", 400.0)),
                )
                self._json(200, {
                    "embeddings": emb.tolist(),
                    "dim": int(emb.shape[1]),
                    "latency_ms": round((time.perf_counter() - t0) * 1000, 2),
                })
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backbone", required=True, help="hub dir or training .pth (zoo.load_model)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32])
    p.add_argument("--batch-window-ms", type=float, default=6.0,
                   help="cross-request coalescing window: after the first "
                        "queued request, wait up to this long to fuse "
                        "concurrent requests into one forward (0 disables)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    service = EmbedService(args.backbone, args.buckets,
                           batch_window_ms=args.batch_window_ms, device=args.device)
    service.warmup()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(dim={service.model.dim}, scale_aware={service.model.scale_aware}, "
          f"device={service.model.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
        server.shutdown()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
