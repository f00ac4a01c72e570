"""Batched alignment engine: bucketing, dispatch over devices, collect.

PyTorch counterpart of `agatha_tpu.engine`.  Pairs
are sorted by sweep length and split into shape-uniform buckets exactly
as the JAX engine splits them (the 128-pair snap of chunks bound for
the column sweep included), so a bucket built here is byte-identical to
the JAX engine's under the same `EngineConfig`.  Each bucket goes to
the column-sweep kernels (`ops.colsweep.align_bucket_colsweep`) where
they are exact and `EngineConfig.colsweep` is on; else, with
`EngineConfig.colband` on (off by default), to the banded column-sweep
kernel (`ops.colband.align_bucket_colband`) where the bucket is
int16-safe; else to the antidiagonal kernel
(`ops.kernel.align_bucket`): exactly where the JAX engine routes it.
On a CUDA device the wire arrays are
copied from pinned host memory without blocking and the kernels are
launched asynchronously on the current stream, so packing bucket i+1
overlaps bucket i on the card; `_collect` synchronises once a device.

With ``traceback=True`` and the default `EngineConfig.traceback_mode`
"device", every bucket (split to the `tb_flag_bytes` cap) goes to
`ops.walk.align_bucket_traceback`: the flag-emitting antidiagonal
kernel, then the walk, queued back to back, so the bucket's flag bitmap
is freed before the next bucket's is allocated.  Right behind its walk,
`_dispatch` queues the copy of the bucket's results and move words into
pinned host memory and an event after it, then hands the engine's one
decode worker thread a job: wait for that event, decode the words.  So
the worker decodes bucket i while the card runs the later buckets and
the host packs them; `_collect` waits for the card once a device, then
for the worker, and puts the rows in input order.  On the CPU the
outputs are on the host already and a job starts at once.  Mode "host"
runs the score path, then the native re-DP engine
(`ops.traceback.traceback_all`).

`align_stream` runs the same path over an iterator in chunks of
``aligns_per_batch`` pairs, with a bounded window of chunks dispatched
and not yet collected (the command line's ``--stream``, `cli`).

`encode_pairs` writes each side's codes with one native pass into a
flat slab that the engine recycles once no code array of an earlier
batch views it (`_Slabs`).

Each step records a span of `agatha_tpu_torch.trace` when tracing is on
(encode, dispatch with validate / pack / stage / launch, collect with
its waits for the card and for the decode worker, the worker's wait for
a bucket's copies and its decode); off, a step pays one flag check.

The engine dispatches over one list of slots (`_slots`): every local
CUDA device when `EngineConfig.use_all_devices` is on and the engine's
device is CUDA, else the engine's device alone; a list pinned on
``_devices`` (`parallel.sharding.make_pairs_mesh`, entries may repeat)
overrides it, as a mesh pinned on the JAX engine's ``_mesh`` does.
With more than one slot the JAX engine's multi-device routes apply:
antidiagonal buckets take "anti-sharded" (rows padded to
len(slots) * B_PAIRS and split over the slots, `parallel.sharding`'s
`stage_shards` then `align_shards`), column-sweep and colband
buckets go whole to the slots in turn, and device-traceback buckets are
split into at least one part a slot and go in turn.  Each slot's work
runs with its device current and on that device's current stream; two
slots on one card run one after the other there.  With one slot the
path is the single-device one.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from agatha_tpu_torch import trace
from agatha_tpu_torch.config import AlignConfig, EngineConfig
from agatha_tpu_torch.io.fasta import SeqPair
from agatha_tpu_torch.ops.colband import (
    align_bucket_colband,
    chain_scalars,
    colband_eligible,
    colband_shapes,
)
from agatha_tpu_torch.ops.colsweep import (
    align_bucket_colsweep,
    bucket_eligible,
    colsweep_shapes,
)
from agatha_tpu_torch.ops.kernel import (
    B_PAIRS,
    LANE,
    align_bucket,
    build_bucket_arrays,
    flag_planes_needed,
    int16_safe,
    window_width,
)
from agatha_tpu_torch.ops.packing import encode_padded
from agatha_tpu_torch.ops.traceback import (
    never_updated_indices,
    traceback_all,
)
from agatha_tpu_torch.ops.walk import (
    align_bucket_traceback,
    decode_moves,
    moves_to_cigar,
)
from agatha_tpu_torch.parallel.sharding import (
    align_shards,
    host_to_device,
    make_pairs_mesh,
    on_device,
    pad_rows,
    stage_shards,
)


def _round_shape(x: int) -> int:
    """Round up to 128 * {1, 2, 3, 4, 6, 8, 12, ...} (geometric grid).

    Bounds padding waste at 50% while keeping the set of bucket shapes
    logarithmic in the length range.
    """
    if x <= LANE:
        return LANE
    if x <= 2 * LANE:
        return 2 * LANE
    p = 2 * LANE
    while True:
        if x <= p:
            return p
        if x <= p + p // 2:
            return p + p // 2
        p *= 2


@dataclasses.dataclass
class AlignmentResult:
    """Per-pair results in input order plus engine statistics."""

    scores: np.ndarray        # int32 (N,)
    query_ends: np.ndarray    # int32 (N,)
    target_ends: np.ndarray   # int32 (N,)
    diags: np.ndarray         # int32 (N,) antidiagonals swept per pair
    n_buckets: int = 0
    kernel_ms: float = 0.0    # wall clock of the dispatch + collect window
    cigars: list[str] | None = None       # when traceback was requested
    bucket_ms: list[float] | None = None  # per-bucket kernel time
    routes: list[str] | None = None       # kernel that served each bucket
                                          # (anti / anti-sharded /
                                          # colsweep / colband / walk)


@dataclasses.dataclass
class _Bucket:
    indices: np.ndarray       # original pair indices (n,)
    meta: np.ndarray          # (GB, 2) int32 [qlen, rlen]
    tcodes: np.ndarray        # (GB, W/2) uint8 nibbles
    qfwd: np.ndarray          # (GB, QF/2) uint8 nibbles


class _Slabs:
    """Code slabs of `AlignEngine.encode_pairs`, recycled across batches.

    A slab is a uint8 array over a bytearray.  Every code array of a
    batch's side is a slice of that side's array, so the array dies with
    the last of them; a finalizer then puts the bytearray on the free
    list, and a later batch writes into pages already faulted in.
    `take` hands out the smallest free slab that is large enough (count
    ``encode.slab_reused``), else a new one with some room over the
    size asked for (``encode.slab_new``), and keeps at most ``keep``
    free.  The finalizer runs on whichever thread drops the last view,
    or inside `take` itself when a collection frees one there, so the
    list is guarded by a reentrant lock.
    """

    def __init__(self, keep: int = 4):
        self.keep = keep
        self._free: list[bytearray] = []
        self._lock = threading.RLock()

    def _give_back(self, buf: bytearray) -> None:
        with self._lock:
            self._free.append(buf)

    def take(self, size: int) -> np.ndarray:
        with self._lock:
            free = self._free
            fits = [i for i, b in enumerate(free) if len(b) >= size]
            buf = (free.pop(min(fits, key=lambda i: len(free[i])))
                   if fits else None)
            while len(free) > self.keep:
                free.pop(min(range(len(free)), key=lambda i: len(free[i])))
        if buf is not None:
            trace.count("encode.slab_reused", 1)
        else:
            # a 16th over, in whole 64 KiB: the next batch of a stream
            # seldom needs more
            buf = bytearray(-(-(size + size // 16) // 65536) * 65536)
            trace.count("encode.slab_new", 1)
        slab = np.frombuffer(buf, np.uint8)
        weakref.finalize(slab, self._give_back, buf).atexit = False
        return slab


class AlignEngine:
    """Aligns arbitrary batches of encoded pairs on the local device(s)."""

    def __init__(
        self,
        cfg: AlignConfig,
        engine_cfg: EngineConfig | None = None,
        *,
        device="cuda",
    ):
        self.cfg = cfg
        self.engine_cfg = engine_cfg or EngineConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch sees no CUDA device"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self._devices = None  # the slots; resolved by _slots()
        self._decoder = None  # the decode worker; started by _decode_pool()
        self._slabs = _Slabs()  # the encoder's code slabs

    # -- input preparation ------------------------------------------------
    def encode_pairs(
        self, pairs: list[SeqPair]
    ) -> list[tuple[np.ndarray, np.ndarray, int, int]]:
        """FASTA pairs -> (q_codes, t_codes, qlen, rlen) with ops applied.

        Uses the native list encoder when it builds, each side's codes
        slices of one slab from the engine's free list (`_Slabs`); falls
        back to the native batch encoder, then to NumPy per pair.
        """
        with trace.span("encode", call=trace.new_call()):
            return self._encode(pairs)

    def _encode(self, pairs):
        from agatha_tpu_torch import native

        if not pairs:
            return []
        q = native.encode_list([p.query for p in pairs],
                               [p.query_op for p in pairs], self._slabs.take)
        t = q and native.encode_list([p.target for p in pairs],
                                     [p.target_op for p in pairs],
                                     self._slabs.take)
        if t:
            (qs, qo, ql), (ts, to, tl) = q, t
            qo, to = qo.tolist(), to.tolist()
            return [(qs[a:b], ts[c:d], x, y) for a, b, c, d, x, y in zip(
                qo, qo[1:], to, to[1:], ql.tolist(), tl.tolist())]
        trace.count("encode.fallback", 1)
        return self._encode_rows(pairs)

    def _encode_rows(self, pairs):
        """The batch encoder's path: each side as padded rows."""
        from agatha_tpu_torch import native

        if native.available():
            def batch(seqs, ops):
                seqs = [s.encode() if isinstance(s, str) else s
                        for s in seqs]
                stride = max(8, -(-max(len(s) for s in seqs) // 8) * 8)
                return native.encode_batch(
                    seqs,
                    np.asarray(ops, np.uint8),
                    stride,
                    n_threads=self.engine_cfg.cpu_threads,
                )

            q_rows, q_lens = batch(
                [p.query for p in pairs], [p.query_op for p in pairs]
            )
            t_rows, t_lens = batch(
                [p.target for p in pairs], [p.target_op for p in pairs]
            )
            out = []
            for i in range(len(pairs)):
                ql, rl = int(q_lens[i]), int(t_lens[i])
                out.append((q_rows[i, : -(-ql // 8) * 8],
                            t_rows[i, : -(-rl // 8) * 8], ql, rl))
            return out

        return [
            (encode_padded(p.query, p.query_op),
             encode_padded(p.target, p.target_op),
             len(p.query), len(p.target))
            for p in pairs
        ]

    # -- bucketing ---------------------------------------------------------
    def make_buckets(
        self, encoded: list[tuple[np.ndarray, np.ndarray, int, int]]
    ) -> list[_Bucket]:
        """Every bucket of a batch at once (`iter_buckets` as a list)."""
        return list(self.iter_buckets(encoded))

    def iter_buckets(
        self, encoded: list[tuple[np.ndarray, np.ndarray, int, int]],
        lane_kernels_ok: bool = True,
    ):
        """Yield buckets one at a time so dispatch overlaps packing.

        The split of `agatha_tpu.engine.AlignEngine.iter_buckets`: sort
        by sweep length, then chunks of ~n/target_buckets pairs, no
        smaller than the work-adaptive floor, no larger than
        aligns_per_batch.  A chunk whose pairs will go to the column
        sweep or the banded column sweep snaps up to a multiple of 128
        pairs (the JAX kernels put 128 pairs on lanes), still under
        aligns_per_batch; ``lane_kernels_ok=False`` (device traceback,
        where no bucket goes to either) turns the snap off.
        """
        n = len(encoded)
        sw = self.cfg.slice_width
        tb = max(1, self.engine_cfg.target_buckets)
        cap = max(B_PAIRS, self.engine_cfg.aligns_per_batch)
        base = min(cap, -(-n // tb))

        lens = np.array([(e[2], e[3]) for e in encoded],
                        np.int64).reshape(n, 2)
        pql = -(-lens[:, 0] // 8)
        prl = -(-lens[:, 1] // 8)
        w_need = prl * 8
        q_need = pql * 8
        d_need = 8 * (-(-(prl + pql - 1) // sw) * sw) + 8

        # Sort by sweep length (the kernel's trip count), then width:
        # pairs sharing a bucket then terminate together.
        order = np.lexsort((w_need, d_need))

        def chunk_pairs(lo: int) -> int:
            """Pairs for the chunk starting at sorted position lo.

            The work-adaptive floor of the JAX engine: a chunk carries
            about TARGET_BUCKET_NS / SUBSTEP_NS base-diagonal steps,
            between 8 and 64 pairs.  Both constants are the JAX
            package's split parameters, kept so the buckets match its
            buckets; they are not times on this device.
            """
            SUBSTEP_NS = 190
            TARGET_BUCKET_NS = 30e6
            pair_ns = max(1, int(d_need[order[lo]]) * SUBSTEP_NS // 8)
            work_floor = -(-int(TARGET_BUCKET_NS // pair_ns) //
                           B_PAIRS) * B_PAIRS
            floor = max(B_PAIRS, min(64, work_floor))
            return min(cap, max(floor, base))

        lo = 0
        while lo < n:
            take = chunk_pairs(lo)
            snap = min(cap, -(-take // LANE) * LANE)
            if snap > take and lane_kernels_ok and self._chunk_lane_mapped(
                    lens[order[lo : lo + snap]]):
                take = snap
            idx = order[lo : lo + take]
            lo += len(idx)
            yield _Bucket(idx, *build_bucket_arrays(
                [encoded[i] for i in idx], self.cfg,
                w=_round_shape(int(w_need[idx].max())),
                # >= 3 lane tiles: the JAX kernel's query staging window
                qf=max(3 * LANE, _round_shape(int(q_need[idx].max()))),
            ))

    # -- dispatch ----------------------------------------------------------
    def align(
        self,
        encoded: list[tuple[np.ndarray, np.ndarray, int, int]],
        *,
        traceback: bool = False,
        per_bucket_times: bool = False,
    ) -> AlignmentResult:
        """Align all pairs (score, query end, target end, diagonals);
        with ``traceback`` also one CIGAR per pair (M both, D target
        only, I query only; "" for a pair the kernel never updated).

        ``per_bucket_times`` fills ``bucket_ms`` with each bucket's
        kernel time: CUDA events around each bucket's launches on a
        CUDA device (the reference's per-batch event time,
        gasal_align.cu:219-236), the host clock around the plain
        versions on the CPU.

        ``kernel_ms`` covers the whole dispatch + collect window, host
        bucket packing and copies included; in host traceback mode it
        stops before the host re-DP, as the JAX engine's does.  A
        ``traceback_mode`` other than "device" runs host mode, as in
        the JAX engine.
        """
        if len(encoded) == 0:
            z = np.zeros(0, np.int32)
            return AlignmentResult(z, z, z, z,
                                   cigars=[] if traceback else None)
        return self._finish(self._start(encoded, traceback,
                                        per_bucket_times), traceback)

    def align_pairs(self, pairs: list[SeqPair]) -> AlignmentResult:
        return self.align(self.encode_pairs(pairs))

    def _start(self, encoded, traceback: bool,
               per_bucket_times: bool = False) -> tuple:
        """Validate and dispatch one batch; returns what `_finish`
        needs.

        Everything a batch's collect reads (its buckets, outputs,
        routes, timings, trace call id and decode jobs) travels in this
        tuple, never on the engine, so several batches can be in flight
        at once (`align_stream`).
        """
        device_tb = traceback and self.engine_cfg.traceback_mode == "device"
        call = trace.new_call()
        with trace.span("dispatch", call=call):
            with trace.span("validate"):
                self._validate(encoded)
            t0 = time.perf_counter()
            return (encoded, t0, call,
                    *self._dispatch(encoded, per_bucket_times, device_tb))

    def _finish(self, started: tuple, traceback: bool) -> AlignmentResult:
        """Collect a batch `_start` dispatched; in host traceback mode
        then run the native re-DP, after ``kernel_ms`` was taken."""
        encoded, t0, call, buckets, outs, routes, timings, decodes = started
        with trace.span("collect", call=call):
            res = self._collect(encoded, buckets, outs, routes, timings, t0,
                                decodes)
        if traceback and res.cigars is None:
            res.cigars = traceback_all(
                encoded, res.query_ends, res.target_ends, res.scores,
                self.cfg, n_threads=self.engine_cfg.cpu_threads,
            )
        return res

    # -- streaming ---------------------------------------------------------
    def align_stream(self, pairs_iter, *, traceback: bool = False,
                     max_in_flight: int = 3):
        """Align an iterator of SeqPairs (or pre-encoded ``(q_codes,
        t_codes, qlen, rlen)`` tuples) in chunks; yield one
        AlignmentResult per chunk, in input order.

        `agatha_tpu.engine.AlignEngine.align_stream`: chunks of
        ``max(B_PAIRS, aligns_per_batch)`` pairs, each encoded,
        validated and dispatched, and at most ``max_in_flight`` chunks
        dispatched and not yet collected.  On a CUDA device a chunk's
        packing, copies and launches are queued before the chunk ahead
        of it is collected (its ``_collect`` is the only wait), so the
        host fills chunk N+1 while the card runs chunk N: the
        reference's double-buffered batches (test_prog.cpp:245-376).
        Host memory is O(chunk), not O(dataset); with device traceback
        each chunk in flight holds its move words in pinned host memory
        and queues its decodes on the engine's one worker behind those
        of the chunks ahead of it, while the flag bitmaps still die
        bucket by bucket.  Each chunk's
        ``kernel_ms`` runs from its dispatch to its collect, so the
        windows of chunks in flight overlap.
        """
        chunk_pairs = max(B_PAIRS, self.engine_cfg.aligns_per_batch)
        it = iter(pairs_iter)
        window: deque = deque()
        while chunk := list(itertools.islice(it, chunk_pairs)):
            encoded = (chunk if isinstance(chunk[0], tuple)
                       else self.encode_pairs(chunk))
            window.append(self._start(encoded, traceback))
            if len(window) >= max_in_flight:
                yield self._finish(window.popleft(), traceback)
        while window:
            yield self._finish(window.popleft(), traceback)

    def _validate(self, encoded) -> None:
        over_range: list[int] = []
        for i, (_qc, _tc, ql, rl) in enumerate(encoded):
            if ql < 1 or rl < 1:
                raise ValueError(
                    f"pair {i}: empty sequence (qlen={ql}, rlen={rl}); "
                    "the aligner requires at least one base per side"
                )
            # 16-bit packing limits shared with the reference: scores
            # < 2^15 from the (H<<16)|r packing, ref ends < 2^16.
            if rl > 0xFFFF or self.cfg.match * min(ql, rl) >= 0x8000:
                over_range.append(i)
        if over_range:
            head = ", ".join(map(str, over_range[:5]))
            more = (f" (+{len(over_range) - 5} more)"
                    if len(over_range) > 5 else "")
            warnings.warn(
                f"{len(over_range)} pair(s) [{head}{more}] exceed the "
                "16-bit score/position packing range shared with the "
                "reference: end positions alias mod 65536 and scores "
                ">= 32768 corrupt the max tracking",
                RuntimeWarning,
                stacklevel=4,
            )

    def _chunk_lane_mapped(self, lens: np.ndarray) -> bool:
        """Whether a chunk's (k, 2) [qlen, rlen] will route to colsweep
        or colband.

        `agatha_tpu.engine.AlignEngine._chunk_lane_mapped`: the gates of
        `_colsweep_ok` and `_colband_ok` before the bucket arrays exist,
        on the widths `build_bucket_arrays` will give the chunk, so the
        128-pair snap fires only on chunks that will route there.
        """
        meta = np.ascontiguousarray(lens, np.int32)
        if self.engine_cfg.colsweep:
            w = _round_shape(int((8 * (-(-meta[:, 1] // 8))).max()))
            qf = max(3 * LANE,
                     _round_shape(int((8 * (-(-meta[:, 0] // 8))).max())))
            if bucket_eligible(meta, w, qf, self.cfg):
                return True
        return self._colband_ok(meta)

    def _colsweep_ok(self, b: _Bucket) -> bool:
        """True when the column-sweep kernels are exact for this bucket:
        `EngineConfig.colsweep` on, the int16-safe regime for the
        bucket's wire widths, a band covering every diagonal, and one
        pair's sweep state in a block's shared memory
        (`ops.colsweep.bucket_eligible`)."""
        return self.engine_cfg.colsweep and bucket_eligible(
            b.meta, 2 * b.tcodes.shape[1], 2 * b.qfwd.shape[1], self.cfg)

    def _colband_ok(self, meta: np.ndarray) -> bool:
        """True when the banded column-sweep kernel serves a bucket (or
        a chunk about to become one) with these (k, 2) [qlen, rlen]:
        `EngineConfig.colband` on and the int16-safe regime.  The
        positive bound is over achievable scores, match * min(qlen,
        rlen) (a prefix alignment consumes at most that many matches),
        the bound `_validate` enforces for the (H << 16) + r packing;
        the wire-width sum colsweep uses would reject 10-16 kb buckets
        that are in range at match = 1.  The band geometry needs no
        check: the slice / chunk / band clipping is implemented.
        Checked after `_colsweep_ok` (the full column sweep where its
        band-coverage condition holds); device traceback keeps the
        antidiagonal kernel (the flag-emitting instance)."""
        if not self.engine_cfg.colband:
            return False
        score_len = int(np.minimum(meta[:, 0], meta[:, 1]).max())
        return colband_eligible(
            meta, self.cfg, int16_safe(self.cfg, max_len=score_len))

    def _slots(self) -> tuple[torch.device, ...]:
        """The engine's one source of devices: the slots of the shard
        split and of the round-robins.

        `agatha_tpu.engine.AlignEngine._local_mesh`: every local CUDA
        device when `EngineConfig.use_all_devices` is on, the engine's
        device is CUDA and there is more than one card; else the
        engine's device alone.  A tuple set on ``_devices`` beforehand
        (`make_pairs_mesh`, entries may repeat) overrides both.
        """
        if self._devices is None:
            mesh = (make_pairs_mesh() if self.engine_cfg.use_all_devices
                    and self.device.type == "cuda" else ())
            self._devices = mesh if len(mesh) > 1 else (self.device,)
        return self._devices

    def _dispatch(self, encoded, per_bucket_times: bool,
                  device_tb: bool = False):
        """Pack each bucket, copy it and launch its kernels, in order.

        Returns the buckets; their outputs (still being computed on a
        CUDA device): a (GB, 4) tensor, the list of its shards' (the
        "anti-sharded" route), or with device traceback the (GB, 4)
        rows on the host (`_Decodes.add`); the route of each bucket;
        with per_bucket_times, one entry per bucket: a list of (start,
        end) CUDA events around the bucket's launches, one pair for
        each device it runs on (every route's copies made before the
        first event, the copies back after the last), or host-clock ms;
        and with device traceback the batch's `_Decodes`, else None.

        Whole buckets take the slots in turn, by the number dispatched
        so far (the JAX engine's ``rr_device`` and ``tb_devs``); with
        more than one slot an antidiagonal bucket is split over all of
        them instead.
        """
        devs = self._slots()
        buckets, outs, routes, timings = [], [], [], []
        decodes = _Decodes(self, trace.current()[0]) if device_tb else None

        def subbuckets():
            for b in self.iter_buckets(encoded,
                                       lane_kernels_ok=not device_tb):
                yield from (self._split_for_flags(b, n_parts=len(devs))
                            if device_tb else (b,))

        def staged(arrays, dev):
            with trace.span("stage"):
                return host_to_device(arrays, dev)

        packed = subbuckets()
        while True:
            with trace.span("pack"):
                b = next(packed, None)
            if b is None:
                break
            dev = devs[len(outs) % len(devs)]
            span = (dev,)
            with on_device(dev):
                if device_tb:
                    routes.append("walk")
                    args = staged((b.meta, b.tcodes, b.qfwd), dev)
                    planes = flag_planes_needed(b.meta, self.cfg)

                    def run():
                        return align_bucket_traceback(*args, self.cfg,
                                                      planes=planes)
                elif self._colsweep_ok(b):
                    routes.append("colsweep")
                    args = staged((b.meta, b.tcodes, b.qfwd), dev)
                    shapes = colsweep_shapes(b.meta, b.tcodes, b.qfwd,
                                             self.cfg)

                    def run():
                        return align_bucket_colsweep(*args, self.cfg,
                                                     shapes=shapes)
                elif self._colband_ok(b.meta):
                    routes.append("colband")
                    *args, scalars = staged(
                        (b.meta, b.tcodes, b.qfwd,
                         chain_scalars(b.meta, self.cfg)), dev)
                    cb_shapes = colband_shapes(b.meta, self.cfg)

                    def run():
                        return align_bucket_colband(
                            *args, self.cfg, shapes=cb_shapes,
                            scalars=scalars)
                elif len(devs) > 1:
                    routes.append("anti-sharded")
                    span = devs
                    unit = len(devs) * B_PAIRS
                    gb = -(-b.meta.shape[0] // unit) * unit
                    padded = (pad_rows(b.meta, gb, 1),
                              pad_rows(b.tcodes, gb), pad_rows(b.qfwd, gb))
                    with trace.span("stage"):
                        shards = stage_shards(*padded, devs)

                    def run():
                        return align_shards(shards, self.cfg, devs)
                else:
                    routes.append("anti")
                    args = staged((b.meta, b.tcodes, b.qfwd), dev)

                    def run():
                        return align_bucket(*args, self.cfg)
                with trace.span("launch"):
                    out = (self._timed(run, span, timings)
                           if per_bucket_times else run())
                    if device_tb:
                        out = decodes.add(*out)
                outs.append(out)
            buckets.append(b)
        if device_tb:
            decodes.dispatching = False
        return buckets, outs, routes, timings, decodes

    @staticmethod
    def _timed(run, span, timings):
        """run() with its time appended to timings: CUDA events on the
        current stream of each distinct device in span, or the host
        clock around the plain versions on the CPU."""
        cuda = list(dict.fromkeys(d for d in span if d.type == "cuda"))
        if not cuda:
            t = time.perf_counter()
            out = run()
            timings.append((time.perf_counter() - t) * 1e3)
            return out
        events = []
        for d in cuda:
            with on_device(d):
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
        out = run()
        for d, (_start, end) in zip(cuda, events):
            with on_device(d):
                end.record()
        timings.append(events)
        return out

    def _split_for_flags(self, b: _Bucket, n_parts: int = 1):
        """Split a bucket so that its flag bitmap fits tb_flag_bytes.

        `agatha_tpu.engine.AlignEngine._split_for_flags`: runs of rows
        (multiples of 8) whose (rows, planes * W_state) int32 bitmap
        stays under the cap; an all-padding tail is dropped.
        ``n_parts`` > 1 also splits into at least that many parts (rows
        permitting), so the round-robin keeps every slot busy when a
        batch packs into fewer buckets than there are slots.
        """
        planes = flag_planes_needed(b.meta, self.cfg)
        w_state = min(2 * b.tcodes.shape[1], window_width(self.cfg))
        per_row = planes * w_state * 4
        max_rows = max(8, (self.engine_cfg.tb_flag_bytes // per_row)
                       // 8 * 8)
        if n_parts > 1:
            per_part = -(-b.meta.shape[0] // n_parts)
            max_rows = min(max_rows, max(8, -(-per_part // 8) * 8))
        gb = b.meta.shape[0]
        if gb <= max_rows:
            yield b
            return
        n_idx = len(b.indices)
        for lo in range(0, gb, max_rows):
            hi = min(gb, lo + max_rows)
            idx = b.indices[lo:min(hi, n_idx)]
            if len(idx) == 0:
                break  # all-padding tail
            yield _Bucket(idx, b.meta[lo:hi], b.tcodes[lo:hi],
                          b.qfwd[lo:hi])

    def _decode_pool(self) -> ThreadPoolExecutor:
        """The engine's one decode worker thread, started on first use.

        Batches in flight (`align_stream`) queue their buckets' decodes
        on it in dispatch order."""
        if self._decoder is None:
            self._decoder = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="agatha-decode")
        return self._decoder

    def _decode_words(self, words: np.ndarray) -> list[str]:
        """One bucket's move words -> CIGARs (native decoder, else the
        NumPy one); runs on the decode worker."""
        from agatha_tpu_torch import native

        cigars = native.moves_to_cigars_batch(
            words, n_threads=self.engine_cfg.cpu_threads)
        if cigars is None:
            cigars = [moves_to_cigar(m) for m in decode_moves(words)]
        return cigars

    def _collect(self, encoded, buckets, outs, routes, timings, t0,
                 decodes=None) -> AlignmentResult:
        """Wait for the results and put the rows in input order.

        Score path: `_gather_rows`, the copies back.  Device traceback
        (``decodes``): the copies back are queued already, each behind
        its bucket's walk, and the worker has been decoding since the
        first of them completed; wait for the card once a device, then
        for the worker's decodes (`_Decodes.wait`), and read the rows
        from pinned host memory.
        """
        n = len(encoded)
        device_tb = decodes is not None
        if device_tb:
            decoded = decodes.wait()
            all_out = torch.cat(outs).numpy()
        else:
            with trace.span("collect.wait_card"):
                all_out = _gather_rows([p for o in outs for p in _parts(o)])
        # a bucket's ms: the longest of its spans, one a device
        bucket_ms = [
            max(s.elapsed_time(e) for s, e in t) if isinstance(t, list)
            else t
            for t in timings
        ] or None
        scores = np.zeros(n, np.int32)
        qends = np.zeros(n, np.int32)
        tends = np.zeros(n, np.int32)
        diags = np.zeros(n, np.int32)
        cigars = [""] * n if device_tb else None
        row = 0
        for i, (b, o) in enumerate(zip(buckets, outs)):
            # rows from the dispatched outputs, not the bucket's meta:
            # the sharded route pads rows to the slots
            rows = sum(p.shape[0] for p in _parts(o))
            out = all_out[row : row + rows]
            row += rows
            k = len(b.indices)
            scores[b.indices] = out[:k, 0]
            qends[b.indices] = out[:k, 1]
            tends[b.indices] = out[:k, 2]
            diags[b.indices] = out[:k, 3]
            if device_tb:
                for j, idx in enumerate(b.indices):
                    cigars[idx] = decoded[i][j]
        if device_tb:
            for i in never_updated_indices(encoded, scores, qends, tends,
                                           self.cfg):
                cigars[i] = ""
        return AlignmentResult(
            scores, qends, tends, diags,
            n_buckets=len(buckets),
            kernel_ms=(time.perf_counter() - t0) * 1e3,
            cigars=cigars,
            bucket_ms=bucket_ms,
            routes=routes,
        )


class _Decodes:
    """One batch's CIGAR decodes on its engine's decode worker.

    `_dispatch` calls `add` with each device-traceback bucket's (out,
    words) right after queueing its kernels; `_collect` calls `wait`.
    A job is submitted only after its event is recorded, so the worker
    never waits on an event a failed launch left unrecorded.
    """

    def __init__(self, engine: AlignEngine, call: int | None):
        self.engine = engine
        self.call = call          # the batch's trace call id
        self.jobs = []            # one future a bucket, in bucket order
        self.ready = {}           # device -> its newest event (CPU: None)
        self.newest = None        # the newest event on any device
        self.dispatching = True   # until _dispatch returns

    def add(self, out: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        """Queue the bucket's copies back and its decode; returns its
        (GB, 4) rows on the host, to be read after `wait`.

        On a CUDA device (the slot's, current here) the copies go into
        pinned memory from the caching host allocator, on the current
        stream, so they run after this bucket's walk and before the next
        bucket's kernels, and an event after them gates the job.  On the
        CPU the tensors are on the host and the job can start at once.
        """
        dev, ready = out.device, None
        if dev.type == "cuda":
            out, words = (
                torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t, non_blocking=True)
                for t in (out, words))
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            self.newest = ready
        self.ready[dev] = ready
        self.jobs.append(self.engine._decode_pool().submit(
            self._decode, words, ready))
        return out

    def _decode(self, words: torch.Tensor, ready) -> list[str]:
        """The worker's job: wait for the bucket's copies, decode."""
        with trace.span("decode.wait_card", self.call):
            if ready is not None:
                ready.synchronize()
        with trace.span("decode", self.call):
            if trace.on:
                trace.count("decode.buckets", 1)
                trace.count("decode.beside_card", self._card_busy())
            return self.engine._decode_words(words.numpy())

    def _card_busy(self) -> bool:
        """Whether the batch still has kernels to run: its newest event
        is pending on a CUDA device; on the CPU, where `_dispatch` runs
        them, dispatch has not returned."""
        if self.newest is None:
            return self.dispatching
        return not self.newest.query()

    def wait(self) -> list[list[str]]:
        """Wait for the card, once a device, then for every decode;
        returns each bucket's CIGARs."""
        for ready in self.ready.values():
            with trace.span("collect.wait_card"):
                if ready is not None:
                    ready.synchronize()
        with trace.span("collect.wait_decode"):
            return [f.result() for f in self.jobs]


def _parts(out) -> list[torch.Tensor]:
    """A dispatched output's (rows, 4) tensors: the shards of the
    sharded route, else the tensor."""
    return out if isinstance(out, list) else [out]


def _gather_rows(parts: list[torch.Tensor]) -> np.ndarray:
    """The batch's (rows, 4) outputs on the host, in order.

    On one device: one concatenation there and one copy back, the only
    synchronisation.  Across devices (the round-robins, or shards on
    several cards): each part copied to pinned host memory without
    blocking, then one wait a device, as the JAX engine's
    ``copy_to_host_async`` branch does.
    """
    devices = list(dict.fromkeys(p.device for p in parts))
    if len(devices) == 1:
        return torch.cat(parts).cpu().numpy()
    host = []
    for p in parts:
        if p.device.type == "cuda":
            with on_device(p.device):
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                p = h.copy_(p, non_blocking=True)
        host.append(p)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return torch.cat(host).numpy()
