"""Pipelined full-frame serving (counterpart of
livecell_tpu/serve/pipeline.py: PipelineStats, run_pipelined).

The three stages of a frame overlap across frames:

    [decode thread]  ->  tiles queue  ->  [caller thread: device]
        ->  futures  ->  [overlay thread pool]

- Decode of frame N+1 runs while frame N is on the card.
- Overlay/figure building for frame N-1 runs in a small thread pool
  while N is on the card and N+1 decodes.
- Device dispatches stay on the caller's thread, one at a time: CUDA
  work and torch.inference_mode (thread-local) stay there, and the
  decode and overlay stages see numpy arrays only.

Throughput becomes max(stage) instead of sum(stages); per-stage wall
times are measured and returned so the pipeline's bound can be
attributed.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, Optional, Tuple


@dataclass
class PipelineStats:
    """Per-stage wall times (seconds, summed over frames) + total."""

    frames: int = 0
    decode_s: float = 0.0
    device_s: float = 0.0
    overlay_s: float = 0.0
    wall_s: float = 0.0
    errors: List[Tuple[Any, BaseException]] = field(default_factory=list)

    def as_dict(self) -> dict:
        n = max(self.frames, 1)
        return {
            "frames": self.frames,
            "decode_ms": round(1e3 * self.decode_s / n, 3),
            "device_ms": round(1e3 * self.device_s / n, 3),
            "overlay_ms": round(1e3 * self.overlay_s / n, 3),
            "pipelined_fps": round(self.frames / self.wall_s, 3)
            if self.wall_s > 0 else 0.0,
            "serial_sum_ms": round(1e3 * (self.decode_s + self.device_s +
                                          self.overlay_s) / n, 3),
        }


_SENTINEL = object()


def run_pipelined(items: Iterable[Any],
                  decode_fn: Callable[[Any], Any],
                  predict_fn: Callable[[Any], Any],
                  consume_fn: Optional[Callable[[Any, Any, Any], Any]],
                  prefetch: int = 2,
                  overlay_workers: int = 2,
                  fetch_fn: Optional[Callable[[Any], Any]] = None
                  ) -> PipelineStats:
    """Drive items through decode -> predict -> consume, overlapped.

    decode_fn(item) -> tiles            (runs on the decode thread)
    predict_fn(tiles) -> detections     (runs on the caller's thread)
    consume_fn(item, tiles, detections) (runs on the overlay pool)

    With `fetch_fn`, the device stage is double-buffered: predict_fn
    becomes the non-blocking dispatch (it enqueues the frame's copy and
    kernels on the card and returns its device tensors) and
    fetch_fn(handle) -> detections the blocking device->host readback.
    Frame N+1 is dispatched BEFORE frame N is fetched, so N's readback
    and host unpack overlap N+1's device compute; "device_ms" then
    reports the dispatch+fetch critical path actually paid per frame.

    A decode failure records the error and skips the frame; a consume
    failure records the error after the run. Device-stage exceptions
    propagate (they mean the program itself is broken).
    """
    stats = PipelineStats()
    tiles_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))

    def decoder():
        for item in items:
            t0 = time.perf_counter()
            try:
                tiles = decode_fn(item)
            except BaseException as e:  # noqa: BLE001 - recorded, not lost
                stats.errors.append((item, e))
                continue
            stats.decode_s += time.perf_counter() - t0
            tiles_q.put((item, tiles))
        tiles_q.put(_SENTINEL)

    t_start = time.perf_counter()
    dec_thread = threading.Thread(target=decoder, daemon=True)
    dec_thread.start()

    futures = []
    inflight: List[Tuple[Any, Any, Any]] = []  # (item, tiles, handle)
    with ThreadPoolExecutor(max_workers=overlay_workers) as pool:
        def finish(item, tiles, handle):
            t0 = time.perf_counter()
            dets = handle if fetch_fn is None else fetch_fn(handle)
            stats.device_s += time.perf_counter() - t0
            if consume_fn is not None:
                def run_consume(item=item, tiles=tiles, dets=dets):
                    t1 = time.perf_counter()
                    consume_fn(item, tiles, dets)
                    return time.perf_counter() - t1

                futures.append((item, pool.submit(run_consume)))
            stats.frames += 1

        while True:
            got = tiles_q.get()
            if got is _SENTINEL:
                break
            item, tiles = got
            t0 = time.perf_counter()
            handle = predict_fn(tiles)
            stats.device_s += time.perf_counter() - t0
            inflight.append((item, tiles, handle))
            if fetch_fn is None or len(inflight) > 1:
                finish(*inflight.pop(0))
        for entry in inflight:
            finish(*entry)
        for item, f in futures:
            try:
                stats.overlay_s += f.result()
            except BaseException as e:  # noqa: BLE001
                stats.errors.append((item, e))
    dec_thread.join()
    stats.wall_s = time.perf_counter() - t_start
    return stats
