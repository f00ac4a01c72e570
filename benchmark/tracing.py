"""Spans around the calls into each layer, and the device trace's reading.

Only a `--trace 1` run installs them.  The spans are the benchmark's own:
they wrap the engine's steps from outside, as the port's
`probes.colsweep_cells.host_split` does (time inside `iter_buckets`'s
generator, the pinned copies, the kernel launches, the collect), and the
harness opens one around `encode_pairs`.  Each span is also a
`torch.profiler.record_function` range, so the trace can say what the
host was doing while the card sat idle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import time

import torch

SPANS = ("encode", "pack", "copy", "launch", "collect")
_LAUNCHERS = ("align_bucket", "align_bucket_traceback",
              "align_bucket_colsweep", "align_bucket_colband",
              "align_shards")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host seconds a batch spent in each span."""

    def __init__(self):
        self._acc: dict[str, float] = collections.defaultdict(float)
        self.per_batch: dict[str, list[float]] = {k: [] for k in SPANS}

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function("bench." + name):
            t = time.perf_counter()
            try:
                yield
            finally:
                self._acc[name] += time.perf_counter() - t

    def end_batch(self) -> None:
        for k in SPANS:
            self.per_batch[k].append(self._acc.pop(k, 0.0))

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped

    def install(self, engine):
        """Wrap the engine's steps in place; returns the undo."""
        import agatha_tpu_torch.engine as eng_mod

        saved = {n: getattr(eng_mod, n) for n in
                 ("host_to_device",) + _LAUNCHERS if hasattr(eng_mod, n)}
        for n, fn in saved.items():
            setattr(eng_mod, n, self._wrap(
                "copy" if n == "host_to_device" else "launch", fn))
        real_iter = engine.iter_buckets

        def iter_timed(enc, **kw):
            it = real_iter(enc, **kw)
            while True:
                with self.span("pack"):
                    b = next(it, None)
                if b is None:
                    return
                yield b

        engine.iter_buckets = iter_timed
        engine._collect = self._wrap("collect", engine._collect)

        def undo():
            for n, fn in saved.items():
                setattr(eng_mod, n, fn)
            for n in ("iter_buckets", "_collect"):
                delattr(engine, n)
        return undo


def _union(intervals):
    """Total length and the merged list of (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read_chrome_trace(path: str, window: str = "bench.window") -> dict:
    """Device time inside the traced window, from the profiler's trace.

    Returns seconds: ``window_s``; ``busy_s`` (any kernel, copy or set
    on the card); ``kernel_s`` (kernel durations summed) and
    ``kernel_busy_s`` (their union); the ten longest device operations
    by name, and the card's idle time inside the window split by the
    benchmark span the host was in, the ten largest.  ``kernel_s`` is 0 when
    the trace holds no device time.
    """
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace has no {window!r} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kern = [], []
    by_name: dict[str, float] = collections.defaultdict(float)
    kernel_s = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e.get("name", "?")] += (t - s) * 1e-6
        if e["cat"] == "kernel":
            kern.append((s, t))
            kernel_s += (t - s) * 1e-6
    busy, merged = _union(dev)
    kernel_busy, _ = _union(kern)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len("bench."):])
                   for e in events if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("bench.")
                   and e["name"] != window and "dur" in e)
    starts = [sp[0] for sp in spans]
    gaps = []
    prev = w0
    for s, t in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    idle: dict[str, float] = collections.defaultdict(float)
    for s, t in gaps:
        # the gap's time in each benchmark span it overlaps (they are
        # disjoint); the rest was outside them
        left = t - s
        j = max(0, bisect.bisect_right(starts, s) - 1)
        while j < len(spans) and spans[j][0] < t:
            part = min(t, spans[j][1]) - max(s, spans[j][0])
            if part > 0:
                idle["host." + spans[j][2]] += part * 1e-6
                left -= part
            j += 1
        if left > 0:
            idle["host.other"] += left * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernel_s": kernel_s,
        "kernel_busy_s": kernel_busy * 1e-6,
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in gap_top],
    }
