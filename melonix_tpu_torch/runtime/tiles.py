"""Spectrogram tile server — the SpecCache/Spec replacement.

Counterpart of ``melonix_tpu/runtime/tiles.py``.  Reference architecture
(spec.cpp:18-42, spec-cache.cpp:10-50): per-column LRU caches keyed by
pixel-column index; a miss enqueues a job for a worker thread and returns a
placeholder (black, stays dirty, repolled every frame) until the spectrum
arrives.  That black-until-ready contract is load-bearing for UI
responsiveness (SURVEY.md §5) and is kept here.

Instead of one FFT per column on a CPU thread, the worker drains the whole
request queue each cycle and computes the pending columns in batches of at
most 256, one launch of the column kernel B7 each (``kernels/columns.py``),
then pools the magnitudes onto the log-frequency texel grid and quantizes
them on the device; only the uint8 value plane of the requested rows comes
back, and the host colormaps it through a 256-entry LUT.  The host keeps an
LRU of RGB tiles (capacity ``max_ranges`` = 4000, range.hpp:4).

**Log-frequency texel grid.**  Tiles are ``tile_texels`` (default 2048)
log-spaced texels over [tile_frac_min, 1] of Nyquist instead of the
reference's 16384 linear bins: >= 14 texels per semitone everywhere.  Each
texel takes the MAX of the DFT bins in its band and falls back to its
nearest bin where bins are sparser than texels (low frequencies).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import OrderedDict, deque
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..engine.spectral import spectrogram_columns_device, track_on_device
from ..ui.colormap import colormap_lut
from ..utils import RateMeter, Timer, registry


# ----------------------------------------------------------------------
# Log-frequency texel grid
# ----------------------------------------------------------------------


def texel_of_frac(frac, texels: int, frac_min: float):
    """Texel index for a frequency expressed as a fraction of Nyquist."""
    f = np.maximum(np.asarray(frac, np.float64), frac_min)
    j = (np.log(f) - np.log(frac_min)) / (-np.log(frac_min)) * (texels - 1)
    return np.clip(np.rint(j).astype(np.int64), 0, texels - 1)


@lru_cache(maxsize=8)
def _resample_tables(n_bins: int, texels: int, frac_min: float):
    """(bin -> texel segment ids, texel -> nearest bin) for the log grid.

    Bins below frac_min (DC and the first few) get segment id ``texels``
    and are dropped; texels whose band holds no bin (low frequencies,
    where bins are sparser than texels) fall back to their nearest bin.
    """
    k = np.arange(n_bins, dtype=np.float64)
    frac = k / n_bins  # bin k center as a fraction of Nyquist
    ids = texel_of_frac(frac, texels, frac_min)
    ids[frac < frac_min] = texels
    j = np.arange(texels, dtype=np.float64)
    frac_j = np.exp(np.log(frac_min) * (1.0 - j / (texels - 1)))
    nearest = np.clip(np.rint(frac_j * n_bins).astype(np.int64), 0, n_bins - 1)
    return ids.astype(np.int32), nearest.astype(np.int32)


def log_resample_np(mags: np.ndarray, texels: int, frac_min: float) -> np.ndarray:
    """NumPy twin of the device resample: (B, n_bins) -> (B, texels)."""
    mags = np.asarray(mags, np.float32)
    ids, nearest = _resample_tables(mags.shape[-1], texels, frac_min)
    pooled = np.zeros((mags.shape[0], texels), np.float32)
    np.maximum.at(pooled, (slice(None), ids[ids < texels]), mags[:, ids < texels])
    return np.maximum(pooled, mags[:, nearest])


class LruCache:
    """Recency cache with the reference's capacity/eviction behavior
    (insert-then-evict-oldest above capacity, spec.cpp:33-40)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()

    def get(self, key):
        if key not in self._d:
            return None
        self._d.move_to_end(key, last=False)  # front = most recent
        return self._d[key]

    def put(self, key, value) -> bool:
        """Insert; returns True when the insert evicted an older entry
        (content for the evicted key reverts to the black placeholder —
        damage the tile server must report to incremental renderers)."""
        self._d[key] = value
        self._d.move_to_end(key, last=False)
        evicted = False
        while len(self._d) > self.capacity:
            self._d.popitem(last=True)
            evicted = True
        return evicted

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


def _tiles_program(wav_dev, starts, ends, kgain: float, ids, nearest, *,
                   size: int, decay: float, texels: int) -> torch.Tensor:
    """(B, texels) uint8 value plane of B columns, on the device of
    ``wav_dev``: B7 magnitudes (its twin on the CPU), the log-texel
    max-pool, the nearest-bin fill, then ``round(clip(tex * k, 0, 255))``.

    ``ids`` maps bins to texel segments and is NOT sorted (dropped bins
    carry id ``texels``): the pool is a scatter-amax into ``texels + 1``
    segments whose last one is discarded.  Magnitudes are >= 0, so a zero
    start equals JAX's ``segment_max`` once the nearest fill is applied.
    """
    mags = spectrogram_columns_device(wav_dev, starts, ends, size=size,
                                      decay=decay)
    b = mags.shape[0]
    pooled = torch.zeros((b, texels + 1), dtype=mags.dtype, device=mags.device)
    pooled.scatter_reduce_(1, ids.to(torch.int64).expand(b, -1), mags, "amax")
    tex = torch.maximum(pooled[:, :texels], mags[:, nearest.to(torch.int64)])
    k = float(np.float32(kgain))
    return torch.round(torch.clamp(tex * k, 0.0, 255.0)).to(torch.uint8)


CHUNK = 256  # most columns per device batch (one B7 launch each)


class TileServer:
    """Async batched spectrogram tiles with the black-until-ready contract.

    ``get_tile(key, start_sample, end_sample)`` returns a
    (config.tile_texels, 3) uint8 RGB log-frequency tile, or None while
    pending (caller draws black and re-requests next frame,
    spec-cache.cpp:67-71).  All requests accumulated between worker cycles
    are computed together, in chunks of at most :data:`CHUNK` columns.

    The track lives on ``device`` (default ``"cuda"``, no fallback; a
    tensor stays on its own device).  ``compute(starts, ends) -> (B,
    n_bins)`` magnitudes replaces the column kernel (e.g.
    ``SpecPyramid.compute_columns``).
    """

    PLACEHOLDER_BINS = 16  # black placeholder texel count (spec-cache.cpp:70)

    def __init__(
        self,
        wav,
        *,
        k: float,
        config: Config = DEFAULT_CONFIG,
        compute: Callable | None = None,
        poll_interval: float = 0.002,
        synchronous: bool = False,
        device=None,
    ):
        self._cfg = config
        self._k = float(k)
        self._wav_dev = track_on_device(wav, device)
        dev = self._wav_dev.device
        n_bins = config.spectr_size // 2
        texels, frac_min = config.tile_texels, config.tile_frac_min
        ids_np, nearest_np = _resample_tables(n_bins, texels, frac_min)
        # Device-resident resample tables, uploaded once.
        ids_dev = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
        nearest_dev = torch.from_numpy(nearest_np.astype(np.int64)).to(dev)
        lut = colormap_lut()

        def _rgb_device(starts, ends, kgain):
            v = _tiles_program(
                self._wav_dev,
                torch.from_numpy(np.asarray(starts, np.int32)).to(dev),
                torch.from_numpy(np.asarray(ends, np.int32)).to(dev),
                kgain, ids_dev, nearest_dev, size=config.spectr_size,
                decay=config.spec_decay, texels=texels,
            )
            return lut[v.cpu().numpy()]

        if compute is not None:
            self._rgb = lambda s, e, kg: lut[
                np.uint8(
                    np.round(
                        np.clip(
                            log_resample_np(compute(s, e), texels, frac_min)
                            * np.float32(kg),
                            0.0,
                            255.0,
                        )
                    )
                )
            ]
        else:
            self._rgb = _rgb_device
        self._cache = LruCache(config.max_ranges)
        self._pending: dict = {}
        # Keys whose batch is computing now: re-polls of a black tile land
        # here instead of _pending, so a drain is never recomputed by the
        # polls that arrive while it runs.
        self._inflight: set = set()
        # Monotonic content version: bumped whenever cached tile CONTENT can
        # change (a drain landed, brightness rebuilt, cache cleared).
        self.epoch = 0
        # Staleness generation: bumped by clear()/set_brightness_k().  A
        # drain captures it at batch time and skips cache.put on mismatch
        # (a clear() mid-drain means the same key now maps to new ranges).
        self._gen = 0
        # Damage log: (epoch-after, keys-landed, evicted) per drain, so a
        # renderer can refresh only the columns a drain touched; cleared by
        # clear()/set_brightness_k() (keys_landed_since then says unknown).
        self._landed_log: deque = deque(maxlen=256)
        self._busy_since: float | None = None  # device batch in flight
        self._lock = threading.Lock()
        self._poll = poll_interval
        self._synchronous = synchronous
        self._running = not synchronous
        self._thread = None
        if not synchronous:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="tile-worker")
            self._thread.start()

    # -- public API ----------------------------------------------------

    def get_tile(self, key: int, start_sample: int, end_sample: int):
        """LRU lookup; miss → enqueue + None (black until ready)."""
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
            if key not in self._inflight:
                self._pending[key] = (int(start_sample), int(end_sample))
        if self._synchronous:
            self._drain_once()
            with self._lock:
                return self._cache.get(key)
        return None

    def get_tiles(self, requests) -> list:
        """Batched ``get_tile`` over (key, start, end) triples under ONE lock
        acquisition (a 1280-column frame would otherwise take 1280)."""
        out = []
        miss = False
        with self._lock:
            for key, s, e in requests:
                hit = self._cache.get(key)
                if hit is None:
                    if key not in self._inflight:
                        self._pending[key] = (int(s), int(e))
                    miss = True
                out.append(hit)
        if self._synchronous and miss:
            self._drain_once()
            with self._lock:
                out = [self._cache.get(r[0]) for r in requests]
        return out

    def prefetch(self, requests) -> None:
        """Enqueue many (key, start, end) at once so the worker computes the
        whole viewport in one drain."""
        with self._lock:
            missing = [
                r for r in requests
                if r[0] not in self._cache and r[0] not in self._inflight
            ]
            for key, s, e in missing:
                self._pending[key] = (int(s), int(e))
        if self._synchronous and missing:
            self._drain_once()

    def set_brightness_k(self, k: float) -> None:
        """Brightness changes rebuild tiles (app.cpp:76-80 drops SpecCache);
        magnitudes aren't cached host-side, so recolor = recompute."""
        with self._lock:
            self._k = float(k)
            self._cache.clear()
            self._landed_log.clear()  # wholesale change: damage unknown
            self._gen += 1
            self.epoch += 1

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._pending.clear()
            # Keys computing under the OLD ranges must be re-requestable
            # with their new ranges now, not after the stale drain lands.
            self._inflight = set()
            self._landed_log.clear()  # wholesale change: damage unknown
            self._gen += 1
            self.epoch += 1

    def keys_landed_since(self, epoch0: int) -> frozenset | None:
        """Union of tile keys whose cached content changed after ``epoch0``.
        None when the damage is unknown — epoch0 predates the log, a
        clear()/brightness change invalidated everything, or an LRU
        eviction reverted unnamed keys — and the caller must recompose."""
        with self._lock:
            if epoch0 == self.epoch:
                return frozenset()
            log = list(self._landed_log)
        if not log or log[0][0] > epoch0 + 1:
            return None  # log truncated/cleared below epoch0: unknown
        out: set = set()
        for ep, keys, evicted in log:
            if ep > epoch0:
                if evicted:
                    return None
                out |= keys
        return frozenset(out)

    def stats(self) -> dict:
        with self._lock:
            busy = self._busy_since
            return {
                "cached": len(self._cache),
                "pending": len(self._pending),
                # Keys handed to the batch in flight: settled means
                # pending == 0 AND inflight == 0.
                "inflight": len(self._inflight),
                "busy_s": 0.0 if busy is None else round(time.monotonic() - busy, 1),
            }

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- worker --------------------------------------------------------

    def _drain_once(self) -> bool:
        with self._lock:
            if not self._pending:
                return False
            batch = list(self._pending.items())
            self._pending.clear()
            self._inflight = {b[0] for b in batch}
            k = self._k
            gen = self._gen
            self._busy_since = time.monotonic()
        try:
            return self._drain_batch(batch, k, gen)
        finally:
            with self._lock:
                self._busy_since = None
                # Only this batch's keys: a clear() mid-flight already reset
                # _inflight, and newly re-requested keys must stay pending.
                self._inflight -= {b[0] for b in batch}

    def _drain_batch(self, batch, k, gen) -> bool:
        keys = [b[0] for b in batch]
        starts = np.asarray([b[1][0] for b in batch], np.int64)
        ends = np.asarray([b[1][1] for b in batch], np.int64)
        n_req = len(keys)
        with registry("tiles.drain", Timer):
            rgb = np.concatenate([
                self._rgb(starts[off: off + CHUNK], ends[off: off + CHUNK], k)
                for off in range(0, n_req, CHUNK)
            ])
        registry("tiles.computed").inc(n_req)
        registry("tiles.chunks").inc(-(-n_req // CHUNK))  # device batches
        registry("tiles.rate", RateMeter).tick(n_req)
        with self._lock:
            # A mid-flight clear()/brightness change bumped _gen: this
            # batch's content is stale — drop it instead of caching it.
            landed = frozenset()
            evicted = False
            if self._gen == gen:
                for i, key in enumerate(keys):
                    evicted |= self._cache.put(key, rgb[i])
                landed = frozenset(keys)
            self.epoch += 1
            self._landed_log.append((self.epoch, landed, evicted))
        return True

    def _run(self) -> None:
        while self._running:
            try:
                busy = self._drain_once()
            except Exception:  # fail-soft: a bad batch must not kill the worker
                traceback.print_exc(file=sys.stderr)
                registry("tiles.worker_errors").inc(1)
                busy = False
            if not busy:
                time.sleep(self._poll)
