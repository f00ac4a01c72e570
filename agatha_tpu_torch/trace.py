"""Spans and counters inside the engine, in memory, off by default.

    from agatha_tpu_torch import trace

    trace.enable()
    res = engine.align(engine.encode_pairs(pairs), traceback=True)
    spans, counts = trace.drain()
    trace.disable()

`enable`, `disable` and `drain` are the whole interface for a caller;
`span`, `count`, `new_call` and `current` are what the instrumented
sites use.
Off, a site costs one check of the module flag `on`: no clock read, no
allocation, no profiler range.  On, each span records its name, the call
id of the batch it belongs to, the name of its parent span, its thread
and its start and end from `time.perf_counter_ns`, and opens
``torch.profiler.record_function("agatha.<name>")``, so that the main
thread's spans sit in a profiler's trace beside the kernels.  Counters
are summed per call id and name.

A span's call id and parent are the innermost span open on its thread,
unless given: the engine's decode worker gives its spans their batch's
call id and no parent (each is a root on the worker's thread, between
its batch's dispatch and the end of its collect).
`AlignEngine._start` takes one call id a batch and carries it to
`_finish`, so the spans of a batch share it with chunks in flight
(`align_stream`); an `encode_pairs` call has a call id of its own.

`drain()` returns ``(spans, counts)``: the `Span` records in the order
they ended, and a dict {(call, name): total} of the counters; and clears
both.  Read it after the call it traces has returned: `_collect` waits
for every decode of its batch before it does.  The spans the engine
records:

    encode               encode_pairs, the whole call
      encode.native      native.encode_list's C++ calls (one a side)
    dispatch             _start: validation, packing, copies, launches
      validate           _validate
      pack               each step of the bucket generator
      stage              each host_to_device / stage_shards
      launch             each route's launcher call (device traceback:
                         and the bucket's copies back and decode job)
    collect              _collect, the whole collect
      collect.wait_card  the wait for the card: the score path's copies
                         back; with device traceback, once a device
      collect.wait_decode  the wait for the decode worker
    decode.wait_card     on the decode worker: one bucket's wait for its
                         copies back (device traceback)
    decode               on the decode worker: one bucket's CIGAR decode

and the counters, each of a CUDA launch only (the plain versions on the
CPU count nothing):

    fill.blocks, fill.slots  each launch of the antidiagonal kernel
                         (B1/B2/B3): its blocks, and its waves times the
                         blocks resident on the card
                         (`ops._nvcc.launch_slots`)
    fill.sweep.blocks, fill.sweep.slots  the same of each column-sweep
                         launch (B4, `ops.colsweep`)
    fill.chain.blocks, fill.chain.slots  the same of each chain launch
                         (B5)
    colsweep.buckets     one a B4 launch
    colsweep.smem        one a B4 launch on the shared-memory instance
                         (zero on a register instance)

and, on the CPU too, in `encode_pairs` ``encode.slab_new`` and ``encode.slab_reused`` (one
a side: its code slab allocated, or taken from the engine's free list)
and ``encode.fallback`` (one a batch on the batch encoder's path), and
on the decode worker ``decode.buckets`` (one a decode) and
``decode.beside_card`` (decodes that began while their batch still had
kernels to run: its newest event pending on a CUDA device; on the CPU,
`_dispatch` not yet returned).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

on = False


class Span(NamedTuple):
    name: str
    call: int | None
    parent: str | None
    thread: int          # threading.get_ident()
    start_ns: int        # time.perf_counter_ns()
    end_ns: int


_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_spans: list[Span] = []
_counts: dict[tuple[int | None, str], int] = {}
_calls = itertools.count()
_open = threading.local()   # .stack: [(name, call)] of this thread


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def drain() -> tuple[list[Span], dict[tuple[int | None, str], int]]:
    """The records since the last drain, and clear them."""
    global _spans, _counts
    with _lock:
        out = _spans, _counts
        _spans, _counts = [], {}
    return out


def new_call() -> int | None:
    """A fresh call id; None with tracing off."""
    return next(_calls) if on else None


def _stack() -> list:
    s = getattr(_open, "stack", None)
    if s is None:
        s = _open.stack = []
    return s


def current() -> tuple[int | None, str | None]:
    """(call id, name) of the innermost span open on this thread, for a
    span another thread records under it; (None, None) if none."""
    stack = _stack() if on else None
    return (stack[-1][1], stack[-1][0]) if stack else (None, None)


class _Timed:
    __slots__ = ("name", "call", "parent", "rf", "t0")

    def __init__(self, name, call, parent):
        self.name, self.call, self.parent = name, call, parent

    def __enter__(self):
        stack = _stack()
        if stack:
            top_name, top_call = stack[-1]
            if self.parent is None:
                self.parent = top_name
            if self.call is None:
                self.call = top_call
        stack.append((self.name, self.call))
        self.rf = torch.profiler.record_function("agatha." + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        rec = Span(self.name, self.call, self.parent,
                   threading.get_ident(), self.t0, t1)
        with _lock:
            _spans.append(rec)
        return False


def span(name: str, call: int | None = None, parent: str | None = None):
    """A span around the block; a shared no-op context with tracing off.

    ``call`` and ``parent`` default to the innermost span open on this
    thread (none: a root span with call id None unless given)."""
    if not on:
        return _NULL
    return _Timed(name, call, parent)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the innermost open span's call."""
    if not on:
        return
    stack = _stack()
    key = (stack[-1][1] if stack else None, name)
    with _lock:
        _counts[key] = _counts.get(key, 0) + int(n)
