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

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from agatha_tpu_torch import AlignConfig, AlignEngine, EngineConfig, SeqPair
from agatha_tpu_torch import trace
from agatha_tpu_torch.ops import colsweep as cs
from agatha_tpu_torch.ops import kernel
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
    assert kernel.launch_slots(512, 396) == 792
    assert kernel.launch_slots(396, 396) == 396
    assert kernel.launch_slots(1, 396) == 396
    assert kernel.launch_slots(0, 396) == 0
    with pytest.raises(ValueError):
        kernel.launch_slots(8, 0)
    asked = []

    def occupancy(cfg, wt, *, safe16, emit_flags=False, device=0):
        asked.append((wt, safe16, emit_flags, device))
        return 2 if emit_flags else 3

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(kernel, "occupancy", occupancy)
    monkeypatch.setattr(kernel, "_resident_cache", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    for _ in range(3):
        assert kernel._resident(CFG, 6144, True, False, 0) == 396
        assert kernel._resident(CFG, 6144, True, True, 0) == 264
    assert asked == [(6144, True, False, 0), (6144, True, True, 0)]
    # a B3 sub-bucket of 160 pairs fills 160 of 264 slots
    assert kernel.launch_slots(160, 264) == 264


class Props:
    multi_processor_count = 132


def test_colsweep_resident_blocks(monkeypatch):
    asked = []

    def occupancy(shapes=None, *, chain=False, device=0):
        asked.append((shapes, chain, device))
        return 12 if chain else 16

    monkeypatch.setattr(cs, "occupancy", occupancy)
    monkeypatch.setattr(cs, "_resident_cache", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    for _ in range(3):
        assert cs._resident((160, 160, 384), False, 0) == 2112
        assert cs._resident((192, 160, 384), False, 0) == 2112
        assert cs._resident(None, True, 0) == 1584
        assert cs._resident(None, True, 1) == 1584
    assert asked == [((160, 160, 384), False, 0), ((192, 160, 384), False, 0),
                     (None, True, 0), (None, True, 1)]
    # a 512-pair short-read bucket: 128 sweep blocks of 4 pairs and 128
    # chain blocks of 4, one wave each
    assert cs.sweep_launch((160, 160, 384)) == (8, 4)
    assert kernel.launch_slots(128, 2112) == 2112
    assert kernel.launch_slots(128, 1584) == 1584


class FakeColsweepLib:
    """Stands in for csrc/colsweep.cu's library: each launch succeeds
    and computes nothing."""

    def agatha_colsweep_sweep(self, *args):
        return 0

    def agatha_colsweep_chain(self, *args):
        return 0


def _bucket(gb, R, Q):
    meta = torch.tensor([[Q, R]] * gb, dtype=torch.int32)
    tcodes = torch.zeros((gb, R // 2), dtype=torch.uint8)
    qfwd = torch.zeros((gb, Q // 2), dtype=torch.uint8)
    shapes = cs.colsweep_shapes(meta.numpy(), tcodes, qfwd, CFG)
    return meta, tcodes, qfwd, shapes


@pytest.fixture
def fake_launches(monkeypatch):
    """The column sweep's CUDA wrappers on CPU tensors against the
    stand-in library, with 16 sweep and 12 chain blocks an SM."""
    monkeypatch.setattr(cs, "build", FakeColsweepLib)
    monkeypatch.setattr(cs, "_device", lambda meta: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    monkeypatch.setattr(cs, "occupancy", lambda shapes=None, *, chain=False,
                        device=0: 12 if chain else 16)
    monkeypatch.setattr(cs, "_resident_cache", {})
    for name in ("launches_sweep", "launches_sweep_smem", "launches_chain"):
        monkeypatch.setattr(cs, name, getattr(cs, name))


def _launch_both(buckets):
    for meta, tcodes, qfwd, shapes in buckets:
        ring = cs.colsweep_sweep_cuda(meta, tcodes, qfwd, CFG, shapes)
        cs.colsweep_chain_cuda(meta, ring, CFG)


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


def test_colsweep_launches_count_nothing_with_tracing_off(fake_launches):
    trace.drain()
    before = cs.launches_sweep, cs.launches_chain
    _launch_both([_bucket(64, 160, 160)])
    assert trace.drain() == ([], {})
    assert (cs.launches_sweep, cs.launches_chain) == (before[0] + 1,
                                                       before[1] + 1)


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
