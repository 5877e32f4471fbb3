"""Write-once decoded-slice cache: PNG tree -> one uint16 memmap.

The port's copy of ``dinox_tpu.data.slice_cache``, on the port's decoder and
canvas resize, with the same on-disk format, so a cache built by either
package opens in the other. Every epoch would otherwise inflate the same
PNGs again; one sequential decode pass and ~0.5 MB of disk a slice make a
"decode" a page-cache copy.

Layout (beside index.csv):

    decoded_cache_c{canvas}.bin    raw uint16, C-order (n, canvas, canvas)
    decoded_cache_c{canvas}.json   {"canvas", "n", "paths": {png_path: row},
                                    "source": {png_path: [size, mtime_ns]}}

The meta file is written last, so an interrupted build is invisible (the
loader decodes PNGs). Lookup is by png_path, so train and val subsets of
one index share one cache; a source file whose size or mtime changed makes
the cache stale.
"""

from __future__ import annotations

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from dinox_torch.data.index import IndexRow
from dinox_torch.data.pipeline import _read_png_u16, _to_canvas

log = logging.getLogger(__name__)

_STEM = "decoded_cache_c{canvas}"


def _fingerprint(paths: list[str]) -> dict[str, list[int]]:
    """(size, mtime_ns) per source PNG — cheap staleness detection. A
    regenerated tree (new seed, new --signature-strength) must never be
    silently served from a cache built against the old pixels."""
    out = {}
    for p in paths:
        st = Path(p).stat()
        out[p] = [st.st_size, st.st_mtime_ns]
    return out


def _source_fresh(meta: dict, want_paths: Optional[list[str]] = None) -> bool:
    """True iff every fingerprinted source file is unchanged on disk (and,
    when *want_paths* is given, every wanted path is covered)."""
    src = meta.get("source")
    if not isinstance(src, dict):
        return False  # legacy meta without fingerprints: treat as stale
    if want_paths is not None and not set(want_paths) <= set(src):
        return False
    for p, (size, mtime_ns) in src.items():
        try:
            st = Path(p).stat()
        except OSError:
            return False
        if st.st_size != size or st.st_mtime_ns != mtime_ns:
            return False
    return True


def cache_paths(index_dir: str | Path, canvas: int) -> tuple[Path, Path]:
    d = Path(index_dir)
    stem = _STEM.format(canvas=canvas)
    return d / f"{stem}.bin", d / f"{stem}.json"


def build_slice_cache(
    rows: list[IndexRow],
    canvas: int,
    out_dir: str | Path,
    *,
    workers: int = 8,
    force: bool = False,
) -> Path:
    """Decode every row's PNG once onto a uint16 memmap. Returns the .bin path."""
    bin_path, meta_path = cache_paths(out_dir, canvas)
    paths = sorted({r.png_path for r in rows})
    if meta_path.exists() and not force:
        try:
            meta = json.loads(meta_path.read_text())
        except Exception:  # noqa: BLE001 - corrupt meta -> rebuild
            meta = None
        if meta is not None and _source_fresh(meta, paths):
            log.info("decoded cache already present and fresh: %s", meta_path)
            return bin_path
        log.info("decoded cache stale or incomplete; rebuilding: %s", meta_path)
    n = len(paths)
    arr = np.memmap(bin_path, dtype=np.uint16, mode="w+",
                    shape=(n, canvas, canvas))
    t0 = time.perf_counter()

    def decode(i: int) -> None:
        arr[i] = _to_canvas(_read_png_u16(paths[i]), canvas)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(decode, range(n)))
    arr.flush()
    del arr
    meta = {"canvas": canvas, "n": n,
            "paths": {p: i for i, p in enumerate(paths)},
            "source": _fingerprint(paths)}
    meta_path.write_text(json.dumps(meta))
    dt = time.perf_counter() - t0
    log.info("decoded cache built: %d slices @%d in %.1fs (%.1f img/s) -> %s",
             n, canvas, dt, n / max(dt, 1e-9), bin_path)
    return bin_path


class SliceCache:
    """Read side: png_path -> decoded (canvas, canvas) uint16 plane."""

    def __init__(self, bin_path: Path, meta: dict):
        self.canvas = int(meta["canvas"])
        self._index: dict[str, int] = meta["paths"]
        self._mm = np.memmap(bin_path, dtype=np.uint16, mode="r",
                             shape=(int(meta["n"]), self.canvas, self.canvas))

    def get(self, png_path: str) -> Optional[np.ndarray]:
        i = self._index.get(png_path)
        if i is None:
            return None
        return self._mm[i]

    def __len__(self) -> int:
        return len(self._index)


def open_slice_cache(index_dir: str | Path, canvas: int) -> Optional[SliceCache]:
    """Open the cache beside *index_dir* if present and canvas-compatible."""
    bin_path, meta_path = cache_paths(index_dir, canvas)
    if not (meta_path.exists() and bin_path.exists()):
        return None
    try:
        meta = json.loads(meta_path.read_text())
        if int(meta["canvas"]) != canvas:
            return None
        expect = int(meta["n"]) * canvas * canvas * 2
        if bin_path.stat().st_size != expect:
            log.warning("decoded cache %s has wrong size; ignoring", bin_path)
            return None
        if not _source_fresh(meta):
            log.warning("decoded cache %s is stale (source PNGs changed since "
                        "build); ignoring — rebuild with --decoded-cache build",
                        bin_path)
            return None
        cache = SliceCache(bin_path, meta)
    except Exception as e:  # noqa: BLE001 - any corruption -> PNG fallback
        log.warning("decoded cache unreadable (%s); falling back to PNG", e)
        return None
    log.info("using decoded-slice cache: %s (%d slices)", bin_path, len(cache))
    return cache
