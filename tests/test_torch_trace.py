"""The engine's spans and counters (`agatha_tpu_torch.trace`).

Imports no jax, so the `cuda` tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py

The CPU tests trace `encode_pairs` + `align` on the plain kernels: every
span under its parent, in its parent's time, with its batch's call id;
the decode worker's spans on its one thread, inside their batch's
dispatch-to-collect window; a bucket's decode while dispatch still
packs the later buckets, and its counters; nothing recorded and no
profiler range opened with tracing off; the launch-fill arithmetic, of
the antidiagonal kernel and of the column sweep's two kernels, whose
counting sites run here against a stand-in for the CUDA library.
"""

import collections
import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from agatha_tpu_torch import AlignConfig, AlignEngine, EngineConfig, SeqPair
from agatha_tpu_torch import trace
from agatha_tpu_torch.ops import _nvcc, kernel, walk
from agatha_tpu_torch.ops import colband as cb
from agatha_tpu_torch.ops import colsweep as cs
from agatha_tpu_torch.probes.colsweep_cells import host_split

torch.set_num_threads(1)

CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                  slice_width=3, z_threshold=400, band_width=60)
# the device-traceback split at 1 MiB of flags puts 8 pairs a bucket
TB = EngineConfig(tb_flag_bytes=1 << 20)

PARENT = {
    "encode": None, "encode.native": "encode",
    "dispatch": None, "validate": "dispatch", "pack": "dispatch",
    "stage": "dispatch", "launch": "dispatch",
    "collect": None, "collect.wait_card": "collect",
    "collect.wait_decode": "collect",
    # the decode worker's: roots on its thread, in their batch's call
    "decode.wait_card": None, "decode": None,
}
WORKER = {"decode.wait_card", "decode"}
SCORE_SPANS = set(PARENT) - WORKER - {"collect.wait_decode"}


def _pairs(n=20, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 140))))
        t = list(q)
        for j in rng.integers(0, len(t), len(t) // 10):
            t[j] = "ACGT"[int(rng.integers(0, 4))]
        out.append(SeqPair(q, "".join(t), 0, 0))
    return out


@pytest.fixture
def traced():
    """Tracing on for the test, off and drained after it."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _run(engine, pairs, traceback):
    enc = engine.encode_pairs(pairs)
    return engine.align(enc, traceback=traceback)


def _check_tree(spans):
    """Parents by name, a call id a batch, every child inside its
    parent, the worker's spans inside their batch's dispatch start to
    collect end; returns the spans by name."""
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    main = threading.get_ident()
    for s in spans:
        assert s.parent == PARENT[s.name], s
        assert s.start_ns <= s.end_ns
        assert (s.thread == main) == (s.name not in WORKER), s
        if s.name in WORKER:
            (d,) = [p for p in by["dispatch"] if p.call == s.call]
            (c,) = [p for p in by["collect"] if p.call == s.call]
            assert d.start_ns <= s.start_ns and s.end_ns <= c.end_ns, s
            continue
        if s.parent is None:
            continue
        # the parent span of the same call that holds it
        holders = [p for p in by[s.parent] if p.call == s.call
                   and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns]
        assert holders, f"{s} lies in no {s.parent} span of its call"
    return by


def test_score_path_spans(traced):
    engine = AlignEngine(CFG, device="cpu")
    res = _run(engine, _pairs(), traceback=False)
    spans, counts = trace.drain()
    by = _check_tree(spans)
    assert set(by) == SCORE_SPANS
    assert len(by["encode"]) == 1 and len(by["encode.native"]) == 2
    (d,), (c,) = by["dispatch"], by["collect"]
    assert d.call == c.call is not None
    assert by["encode"][0].call != d.call
    assert len(by["launch"]) == len(by["stage"]) == res.n_buckets
    # one step of the bucket generator a bucket, and the one that ends it
    assert len(by["pack"]) == res.n_buckets + 1
    # no CUDA launch, no fill counter; a new slab a side of the batch
    assert counts == {(by["encode"][0].call, "encode.slab_new"): 2}


def test_encode_counts_its_slabs_and_fallbacks(traced, monkeypatch):
    """`encode_pairs` counts a slab a side under its own call id: new
    while the earlier batch is held, reused once it is dropped; and one
    ``encode.fallback`` for a batch that takes the batch encoder."""
    from agatha_tpu_torch import native

    engine = AlignEngine(CFG, device="cpu")
    pairs = _pairs()

    def counted():
        spans, counts = trace.drain()
        (enc,) = [s for s in spans if s.name == "encode"]
        assert {c for c, _k in counts} == {enc.call}
        return {k: v for (_c, k), v in counts.items()}

    a = engine.encode_pairs(pairs)
    assert counted() == {"encode.slab_new": 2}
    b = engine.encode_pairs(pairs)
    assert counted() == {"encode.slab_new": 2}
    del a
    c = engine.encode_pairs(pairs)
    assert counted() == {"encode.slab_reused": 2}
    monkeypatch.setattr(native, "_enc", None)
    monkeypatch.setattr(native, "_enc_tried", True)
    d = engine.encode_pairs(pairs)
    assert counted() == {"encode.fallback": 1}
    for x in (b, c):
        assert [(q.tobytes(), t.tobytes(), ql, rl) for q, t, ql, rl in x] \
            == [(q.tobytes(), t.tobytes(), ql, rl) for q, t, ql, rl in d]


def test_device_traceback_spans(traced):
    engine = AlignEngine(CFG, TB, device="cpu")
    res = _run(engine, _pairs(), traceback=True)
    spans, counts = trace.drain()
    by = _check_tree(spans)
    assert set(by) == set(PARENT)
    assert res.n_buckets > 1
    # one wait for the card a device; a decode and its wait a bucket
    assert len(by["collect.wait_card"]) == 1
    assert len(by["decode"]) == len(by["decode.wait_card"]) == res.n_buckets
    call = by["collect"][0].call
    work = by["decode"] + by["decode.wait_card"]
    assert {s.call for s in work} == {call}
    assert len({s.thread for s in work}) == 1
    assert by["dispatch"][0].call == call
    # the worker's decodes all end before the wait for them does
    (w,) = by["collect.wait_decode"]
    assert max(s.end_ns for s in by["decode"]) <= w.end_ns
    assert counts[(call, "decode.buckets")] == res.n_buckets
    assert 0 <= counts[(call, "decode.beside_card")] <= res.n_buckets


def test_decode_runs_while_dispatch_packs(traced):
    """`iter_buckets` holds its third bucket back until the first
    bucket's decode has started (for at most 10 s), so the batch
    finishes on time only if a decode runs while dispatch still packs;
    the results equal a plain run's."""
    ecfg = EngineConfig(aligns_per_batch=8, tb_flag_bytes=1 << 20)
    pairs = _pairs(24)
    plain = _run(AlignEngine(CFG, ecfg, device="cpu"), pairs, True)
    engine = AlignEngine(CFG, ecfg, device="cpu")
    started = threading.Event()
    real_decode, real_iter = engine._decode_words, engine.iter_buckets
    held = []

    def decode(words):
        started.set()
        return real_decode(words)

    def gated(encoded, **kw):
        for k, b in enumerate(real_iter(encoded, **kw)):
            if k == 2:
                held.append(started.wait(timeout=10))
            yield b

    engine._decode_words, engine.iter_buckets = decode, gated
    trace.drain()
    res = _run(engine, pairs, True)
    spans, counts = trace.drain()
    assert held == [True], "no decode began while dispatch was packing"
    by = _check_tree(spans)
    (d,) = by["dispatch"]
    assert min(s.start_ns for s in by["decode"]) < d.end_ns
    assert res.n_buckets >= 3
    assert counts[(d.call, "decode.buckets")] == res.n_buckets
    assert counts[(d.call, "decode.beside_card")] >= 1
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert np.array_equal(getattr(res, f), getattr(plain, f)), f
    assert res.cigars == plain.cigars and any(res.cigars)


def test_chunks_in_flight_share_one_decode_worker(traced):
    """align_stream with CIGARs: the chunks in flight queue their
    decodes on the engine's one worker, in dispatch order."""
    engine = AlignEngine(CFG, EngineConfig(aligns_per_batch=8,
                                           tb_flag_bytes=1 << 20),
                         device="cpu")
    pairs = _pairs(24)
    chunks = list(engine.align_stream(iter(pairs), traceback=True,
                                      max_in_flight=3))
    spans, counts = trace.drain()
    _check_tree(spans)
    work = sorted((s for s in spans if s.name in WORKER),
                  key=lambda s: s.start_ns)
    assert len({s.thread for s in work}) == 1
    calls = [s.call for s in work]
    assert calls == sorted(calls) and len(set(calls)) == len(chunks) == 3
    assert sum(v for (_c, k), v in counts.items()
               if k == "decode.buckets") == sum(c.n_buckets for c in chunks)
    whole = engine.align(engine.encode_pairs(pairs), traceback=True)
    assert sum((c.cigars for c in chunks), []) == whole.cigars


def test_chunks_in_flight_keep_their_call_ids(traced):
    engine = AlignEngine(CFG, EngineConfig(aligns_per_batch=8),
                         device="cpu")
    chunks = list(engine.align_stream(iter(_pairs(24)), max_in_flight=3))
    spans, _counts = trace.drain()
    _check_tree(spans)
    dispatch = [s.call for s in spans if s.name == "dispatch"]
    collect = [s.call for s in spans if s.name == "collect"]
    assert len(chunks) == 3 and len(set(dispatch)) == 3
    # every chunk is dispatched before the first is collected
    assert collect == dispatch
    first_collect = min(s.start_ns for s in spans if s.name == "collect")
    assert all(s.end_ns <= first_collect for s in spans
               if s.name == "dispatch")


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    engine = AlignEngine(CFG, TB, device="cpu")
    pairs = _pairs()
    trace.drain()
    trace.enable()
    try:
        on = [_run(engine, pairs, tb) for tb in (False, True)]
    finally:
        trace.disable()
    assert trace.drain()[0]

    def refuse(*_a, **_kw):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = [_run(engine, pairs, tb) for tb in (False, True)]
    assert trace.drain() == ([], {})
    assert trace.new_call() is None and trace.current() == (None, None)
    for a, b in zip(on, off):
        for f in ("scores", "query_ends", "target_ends", "diags"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        assert a.cigars == b.cigars and a.routes == b.routes


def test_counters_sum_per_call(traced):
    trace.count("x", 2)                       # no span open: call None
    with trace.span("outer", call=7):
        trace.count("x", 3)
        with trace.span("inner"):
            trace.count("x", 4)
            assert trace.current() == (7, "inner")
    spans, counts = trace.drain()
    assert counts == {(None, "x"): 2, (7, "x"): 7}
    assert [(s.name, s.call, s.parent) for s in spans] == [
        ("inner", 7, "outer"), ("outer", 7, None)]


def test_counters_lose_no_update_across_threads(traced):
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with trace.span("w", call=k % 2):
                for _ in range(n_adds):
                    trace.count("n", 1)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans, counts = trace.drain()
    assert len(spans) == n_threads
    assert counts == {(0, "n"): n_threads // 2 * n_adds,
                      (1, "n"): n_threads // 2 * n_adds}


def test_launch_slots_and_resident_blocks(monkeypatch):
    # 16 buckets of 512 blocks against 132 SMs x 3 resident: 2 waves
    assert _nvcc.launch_slots(512, 396) == 792
    assert _nvcc.launch_slots(396, 396) == 396
    assert _nvcc.launch_slots(1, 396) == 396
    assert _nvcc.launch_slots(0, 396) == 0
    with pytest.raises(ValueError):
        _nvcc.launch_slots(8, 0)
    asked = []

    def query(per_sm):
        def ask():
            asked.append(per_sm)
            return _nvcc.blocks_per_sm(per_sm)
        return ask

    monkeypatch.setattr(_nvcc, "_residents", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    for _ in range(3):
        assert _nvcc.resident(("antidiag", 6144, False), query(3), 0) == 396
        assert _nvcc.resident(("antidiag", 6144, True), query(2), 0) == 264
        assert _nvcc.resident(("antidiag", 6144, True), query(2), 1) == 264
    # asked once per (key, device)
    assert asked == [3, 2, 2]
    # a B3 sub-bucket of 160 pairs fills 160 of 264 slots
    assert _nvcc.launch_slots(160, 264) == 264
    # a failed query (minus its CUDA error) raises and is not cached
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _nvcc.resident(("antidiag", 128, False), query(-2), 0)
    assert ("antidiag", 128, False) not in {k for k, _d in _nvcc._residents}


class Props:
    multi_processor_count = 132


class FakeCDLL:
    """Stands in for the build of every csrc/ source: records each call;
    a launch returns `err`, an occupancy query its blocks per SM (16
    sweep, 12 chain; 3 antidiagonal score, 2 flags)."""

    def __init__(self):
        self.calls = []
        self.err = 0

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((entry, args))
            if entry == "agatha_colsweep_occupancy":
                return 12 if args[0] else 16
            if entry == "agatha_antidiag_occupancy":
                return 2 if args[3] else 3
            return self.err
        setattr(self, entry, fn)
        return fn

    def asked(self, entry):
        return [args for e, args in self.calls if e == entry]


@pytest.fixture
def fake_launches(monkeypatch):
    """Every CUDA launcher on CPU tensors against one stand-in library
    (`_nvcc.build` returns it), on device 0 of 132 SMs, with launch
    counts and resident blocks of their own."""
    lib = FakeCDLL()
    lib.built = []

    def build(*names):
        lib.built += names
        return [(lib, "")] * len(names)

    monkeypatch.setattr(_nvcc, "build", build)
    for mod in (kernel, cs, walk, cb):
        monkeypatch.setattr(mod.LIB, "_fns", None)
        monkeypatch.setattr(mod.LIB, "log", "")
    monkeypatch.setattr(_nvcc, "device", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    monkeypatch.setattr(_nvcc, "launches", collections.Counter())
    monkeypatch.setattr(_nvcc, "_residents", {})
    return lib


def _bucket(gb, R, Q):
    meta = torch.tensor([[Q, R]] * gb, dtype=torch.int32)
    tcodes = torch.zeros((gb, R // 2), dtype=torch.uint8)
    qfwd = torch.zeros((gb, Q // 2), dtype=torch.uint8)
    shapes = cs.colsweep_shapes(meta.numpy(), tcodes, qfwd, CFG)
    return meta, tcodes, qfwd, shapes


def _launch_both(buckets):
    for meta, tcodes, qfwd, shapes in buckets:
        ring = cs.colsweep_sweep_cuda(meta, tcodes, qfwd, CFG, shapes)
        cs.colsweep_chain_cuda(meta, ring, CFG)


def test_colsweep_resident_blocks(fake_launches, traced):
    """The sweep asks its occupancy once per (shapes, device), the chain
    once per device; 16 and 12 blocks an SM of 132."""
    short, wide = _bucket(512, 160, 160), _bucket(512, 192, 160)
    with trace.span("launch", call=1):
        _launch_both([short, short, wide, short])
    _spans, counts = trace.drain()
    assert fake_launches.asked("agatha_colsweep_occupancy") == [
        (0, *short[3], 4, 8, 0), (1, 0, 0, 0, 1, 0, 0),
        (0, *wide[3], 4, cs.sweep_rows(wide[3][0]), 0)]
    # a 512-pair short-read bucket: 128 sweep blocks of 4 pairs and 128
    # chain blocks of 4, one wave each
    assert cs.sweep_launch(short[3]) == (8, 4)
    assert counts[1, "fill.sweep.slots"] == 4 * 2112
    assert counts[1, "fill.chain.slots"] == 4 * 1584
    assert fake_launches.built == ["colsweep.cu"]


def test_colsweep_launches_count_their_fill(fake_launches, traced):
    # 512 pairs on a register instance, 37 pairs of 1056 rows on the
    # shared-memory instance; 4 pairs a block on both
    short = _bucket(512, 160, 160)
    wide = _bucket(37, 1056, 160)
    assert cs.sweep_launch(short[3])[0] > 0
    assert cs.sweep_launch(wide[3])[0] == 0
    assert cs.sweep_launch(wide[3])[1] == 4
    with trace.span("launch", call=3):
        _launch_both([short, wide])
    _spans, counts = trace.drain()
    assert counts == {
        (3, "colsweep.buckets"): 2,
        (3, "colsweep.smem"): 1,
        (3, "fill.sweep.blocks"): 128 + 10,
        (3, "fill.sweep.slots"): 2112 + 2112,
        (3, "fill.chain.blocks"): 128 + 10,
        (3, "fill.chain.slots"): 1584 + 1584,
    }
    # the antidiagonal kernel's counters stay its own
    assert not any(k.startswith("fill.blocks") for _c, k in counts)
    assert _nvcc.launches == {"colsweep.sweep.regs": 1,
                              "colsweep.sweep.smem": 1,
                              "colsweep.chain": 2}


def test_colsweep_launches_count_nothing_with_tracing_off(fake_launches):
    trace.drain()
    _launch_both([_bucket(64, 160, 160)])
    assert trace.drain() == ([], {})
    assert _nvcc.launches == {"colsweep.sweep.regs": 1, "colsweep.chain": 1}
    assert _nvcc.launched("colsweep.sweep") == 1
    assert not fake_launches.asked("agatha_colsweep_occupancy")


def _antidiag_bucket(gb):
    """gb pairs of 8 x 8 on the narrowest wire (W 128, QF 384)."""
    meta = torch.full((gb, 2), 8, dtype=torch.int32)
    return (meta, torch.zeros((gb, 64), dtype=torch.uint8),
            torch.zeros((gb, 192), dtype=torch.uint8))


def test_antidiag_launches_count_their_fill(fake_launches, traced):
    """400 pairs (one block each) against 396 score / 264 flags blocks
    resident: two waves each; each instance asks its occupancy once."""
    bucket = _antidiag_bucket(400)
    with trace.span("launch", call=5):
        for planes in (0, 0, 256, 256):
            kernel._align_bucket_cuda(*bucket, CFG, False, planes)
    _spans, counts = trace.drain()
    assert counts == {(5, "fill.blocks"): 4 * 400,
                      (5, "fill.slots"): 2 * 792 + 2 * 528}
    assert _nvcc.launches == {"antidiag.score": 2, "antidiag.flags": 2}
    assert fake_launches.asked("agatha_antidiag_occupancy") == [
        (128, CFG.band_width, 1, 0, 0), (128, CFG.band_width, 1, 1, 0)]
    launch = fake_launches.asked("agatha_antidiag")[-1]
    assert launch[4] == 400 and launch[-3:] == (256, 0, 0)  # planes, dev,
    assert fake_launches.built == ["antidiag.cu"]            # stream
    assert fake_launches.agatha_antidiag.argtypes == \
        kernel.LIB.signatures["agatha_antidiag"][0]


def _walk_inputs(gb, planes=4, W=128):
    return (torch.zeros((gb, planes * W), dtype=torch.int32),
            torch.zeros(planes, dtype=torch.int32),
            torch.zeros((gb, 4), dtype=torch.int32))


def test_walk_launch_counts(fake_launches):
    words = walk._walk_cuda(*_walk_inputs(24))
    assert words.shape == (24, walk.words_per_pair(4))
    assert walk._walk_cuda(*_walk_inputs(0)).shape[0] == 0
    assert _nvcc.launches == {"walk": 1}
    (args,) = fake_launches.asked("agatha_walk")
    assert args[4:] == (24, 4, 128, walk.words_per_pair(4), 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        flags, vbases, ends = _walk_inputs(24)
        walk._walk_cuda(flags, vbases, ends.t().contiguous().t())
    assert _nvcc.launches == {"walk": 1}
    assert fake_launches.built == ["walk.cu"]


def _colband_inputs(gb=8, q=200, r=240):
    meta = np.array([[q, r]] * gb, np.int32)
    shapes = cb.colband_shapes(meta, CFG)
    return (torch.from_numpy(cb.chain_scalars(meta, CFG)),
            torch.zeros((gb, shapes[1] // 2), dtype=torch.uint8),
            torch.zeros((gb, shapes[2] // 2), dtype=torch.uint8), shapes)


def test_colband_launches_count_by_rows(fake_launches):
    scalars, tcodes, qfwd, shapes = _colband_inputs()
    rows = cb.colband_rows(shapes[0])
    cb.colband_cuda(scalars, tcodes, qfwd, CFG, shapes)
    cb.colband_cuda(scalars, tcodes, qfwd, CFG, shapes, rows=8)
    assert _nvcc.launches == collections.Counter(
        {f"colband.r{rows}": 1}) + collections.Counter({"colband.r8": 1})
    assert _nvcc.launched("colband") == 2
    assert [a[-4:] for a in fake_launches.asked("agatha_colband")] == [
        (rows, None, 0, 0), (8, None, 0, 0)]
    assert fake_launches.built == ["colband.cu"]


def _launch_sweep(meta, tcodes, qfwd, shapes):
    return cs.colsweep_sweep_cuda(meta, tcodes, qfwd, CFG, shapes)


FAILING = {
    "antidiag.score": lambda: kernel._align_bucket_cuda(
        *_antidiag_bucket(8), CFG, False, 0),
    "antidiag.flags": lambda: kernel._align_bucket_cuda(
        *_antidiag_bucket(8), CFG, False, 256),
    "colsweep.sweep.regs": lambda: _launch_sweep(*_bucket(8, 160, 160)),
    "colsweep.chain": lambda: cs.colsweep_chain_cuda(
        _bucket(8, 160, 160)[0], torch.zeros((384, 8), dtype=torch.int32),
        CFG),
    "walk": lambda: walk._walk_cuda(*_walk_inputs(8)),
    "colband.r8": lambda: cb.colband_cuda(*_colband_inputs()[:3], CFG,
                                          _colband_inputs()[3], rows=8),
}


@pytest.mark.parametrize("name", list(FAILING))
def test_failed_launch_raises_and_counts_nothing(fake_launches, traced,
                                                 name):
    """A non-zero return raises RuntimeError naming the instance and its
    CUDA error, counts no launch and no fill."""
    fake_launches.err = 719
    with pytest.raises(RuntimeError,
                       match=rf"^{name} launch failed: CUDA error 719$"):
        FAILING[name]()
    assert not _nvcc.launches
    assert trace.drain() == ([], {})
    fake_launches.err = 0
    FAILING[name]()
    assert _nvcc.launches == {name: 1}


def test_host_split_keys_on_the_cpu():
    engine = AlignEngine(CFG, TB, device="cpu")
    enc = engine.encode_pairs(_pairs())
    for tb in (False, True):
        split = host_split(engine, enc, traceback=tb)
        assert list(split) == ["validate", "pack", "copy", "launch",
                               "collect", "other", "wall"]
        assert all(v >= 0 for k, v in split.items() if k != "other")
        assert split["launch"] + split["collect"] <= split["wall"]
    assert not trace.on and trace.drain() == ([], {})
    trace.enable()
    try:
        with pytest.raises(RuntimeError, match="tracing off"):
            host_split(engine, enc)
    finally:
        trace.disable()


@pytest.mark.cuda
def test_card_fill_and_profiler_ranges(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from agatha_tpu_torch import make_workload

    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=751)
    engine = AlignEngine(cfg, EngineConfig(use_all_devices=False))
    enc = make_workload(256, 2000, seed=5)
    engine.align(enc, traceback=True)  # builds the kernels
    trace.drain()
    trace.enable()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for tb in (False, True):
                engine.align(enc, traceback=tb)
    finally:
        trace.disable()
    spans, counts = trace.drain()
    blocks = sum(v for (_c, k), v in counts.items() if k == "fill.blocks")
    slots = sum(v for (_c, k), v in counts.items() if k == "fill.slots")
    assert 0 < blocks <= slots
    assert {s.name for s in spans} >= set(PARENT) - {"encode",
                                                      "encode.native"}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    for n in ("agatha.dispatch", "agatha.launch", "agatha.collect",
              "agatha.collect.wait_card", "agatha.collect.wait_decode"):
        assert n in names, n


@pytest.mark.cuda
def test_card_short_reads_count_the_column_sweep_fill():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from agatha_tpu_torch import make_workload

    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=751)
    engine = AlignEngine(cfg, EngineConfig(use_all_devices=False))
    enc = make_workload(2048, 150, seed=19, spread=0.05)
    engine.align(enc)  # builds the kernels
    counts = {}
    host_split(engine, enc, counts=counts)
    res = engine.align(enc)
    assert set(res.routes) == {"colsweep"}
    assert counts["colsweep.buckets"] == res.n_buckets
    assert counts["colsweep.smem"] == 0
    for k in ("sweep", "chain"):
        blocks = counts[f"fill.{k}.blocks"]
        assert 0 < blocks <= counts[f"fill.{k}.slots"]
    # 4 pairs a block in both kernels
    assert counts["fill.sweep.blocks"] == counts["fill.chain.blocks"] \
        == sum(-(-b.meta.shape[0] // 4) for b in engine.make_buckets(enc))
    assert "fill.blocks" not in counts
    # tracing off: nothing is recorded
    engine.align(enc)
    assert trace.drain() == ([], {})
