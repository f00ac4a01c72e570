"""Port's engine vs the JAX engine, the oracle and the golden logs."""

import dataclasses
import os
import time
import warnings

import numpy as np
import pytest
import torch

from agatha_tpu.config import AlignConfig, EngineConfig
from agatha_tpu.engine import AlignEngine as JaxEngine
from agatha_tpu.io.fasta import read_fasta_pairs
from agatha_tpu.ops.packing import encode_padded
from agatha_tpu.ops.sweep import align_one_sweep
from agatha_tpu_torch.config import config_from
from agatha_tpu_torch.engine import AlignEngine, _round_shape
from agatha_tpu_torch.parallel.sharding import host_to_device

from .conftest import mutate, random_seq

torch.set_num_threads(1)

CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("scores", "query_ends", "target_ends", "diags")



def _mixed(rng, n, lo, hi, n_frac=0.01):
    enc = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(lo, hi)), n_frac)
        t = (mutate(rng, q) if i % 2 else
             random_seq(rng, int(rng.integers(lo, hi)), n_frac))
        enc.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return enc


def _assert_oracle(res, enc, cfg):
    for i, (qc, tc, ql, rl) in enumerate(enc):
        exp = align_one_sweep(qc, tc, ql, rl, cfg)
        got = (int(res.scores[i]), int(res.query_ends[i]),
               int(res.target_ends[i]))
        assert got == tuple(exp), f"pair {i}"


def test_round_shape_grid():
    for x, want in [(1, 128), (128, 128), (129, 256), (300, 384),
                    (400, 512), (1000, 1024), (1100, 1536)]:
        assert _round_shape(x) == want
    for x in [5, 130, 700, 5000, 99999]:
        assert _round_shape(x) % 128 == 0 and _round_shape(x) >= x


@pytest.mark.parametrize("engine_cfg", [
    EngineConfig(),
    EngineConfig(target_buckets=4),
    EngineConfig(aligns_per_batch=24),
    EngineConfig(colsweep=False),
])
def test_buckets_byte_identical_to_jax(rng, engine_cfg):
    """Same indices, meta and nibble wire as the JAX engine under the
    same EngineConfig (the 128-pair colsweep snap included); no kernel
    runs."""
    enc = _mixed(rng, 300, 20, 3000)
    ref_cfg = dataclasses.replace(engine_cfg, use_all_devices=False)
    ref = list(JaxEngine(CFG, ref_cfg, interpret=True).iter_buckets(enc))
    got = list(AlignEngine(config_from(CFG), config_from(engine_cfg),
                           device="cpu").iter_buckets(enc))
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert (a.indices == b.indices).all()
        for f in ("meta", "tcodes", "qfwd"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f


def test_long_read_split_matches_jax(rng):
    """Long pairs take the work-adaptive floor below 64 pairs."""
    enc = []
    for i in range(64):
        s = random_seq(rng, 40000 + 7 * i)
        enc.append((encode_padded(s), encode_padded(s), len(s), len(s)))
    same = EngineConfig(use_all_devices=False)
    ref = [len(b.indices)
           for b in JaxEngine(CFG, same, interpret=True).iter_buckets(enc)]
    got = [len(b.indices)
           for b in AlignEngine(CFG, device="cpu").iter_buckets(enc)]
    assert got == ref and max(got) < 64


def test_to_device_cpu_tensors(rng):
    b = next(AlignEngine(CFG, device="cpu").iter_buckets(_mixed(rng, 5, 10,
                                                                 90)))
    meta, tcodes, qfwd = host_to_device((b.meta, b.tcodes, b.qfwd), "cpu")
    assert meta.dtype == torch.int32 and tcodes.dtype == torch.uint8
    assert (meta.numpy() == b.meta).all()
    assert tcodes.numpy().tobytes() == b.tcodes.tobytes()
    assert qfwd.numpy().tobytes() == b.qfwd.tobytes()


def test_align_matches_jax_engine_mixed_windowed_and_full(rng):
    """One align() call spanning full-width and windowed buckets equals
    the JAX engine (interpret mode), diagonal counts included."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=300)
    enc = []
    q = random_seq(rng, 700)  # window_width(300) = 640: windowed
    t = mutate(rng, q)
    enc.append((encode_padded(q), encode_padded(t), 700, len(t)))
    for i in range(15):
        s = random_seq(rng, 30 + 8 * i)
        t = mutate(rng, s)
        enc.append((encode_padded(s), encode_padded(t), len(s), len(t)))
    # about the antidiagonal route: colsweep off on both sides
    ecfg = EngineConfig(aligns_per_batch=8, colsweep=False)
    res = AlignEngine(cfg, ecfg, device="cpu").align(enc)
    ref = JaxEngine(cfg, EngineConfig(aligns_per_batch=8, colsweep=False,
                                      colband=False),
                    interpret=True).align(enc)
    assert res.n_buckets == ref.n_buckets >= 2
    assert res.routes == ["anti"] * res.n_buckets
    for f in FIELDS:
        assert (getattr(res, f) == getattr(ref, f)).all(), f
    _assert_oracle(res, enc, cfg)


def test_align_matches_oracle_mixed_lengths(rng):
    enc = _mixed(rng, 20, 1, 200, 0.02)
    res = AlignEngine(CFG, EngineConfig(aligns_per_batch=8),
                      device="cpu").align(enc, per_bucket_times=True)
    assert res.n_buckets == 3 and "colsweep" in res.routes
    assert len(res.bucket_ms) == 3 and all(m >= 0 for m in res.bucket_ms)
    _assert_oracle(res, enc, CFG)


def _golden_lines(cfg, qfile, tfile):
    engine = AlignEngine(cfg, device="cpu")
    pairs = read_fasta_pairs(os.path.join(GOLDEN, qfile),
                             os.path.join(GOLDEN, tfile))
    res = engine.align_pairs(pairs)
    return "".join(
        f"{res.scores[i]}\tquery_batch_end={res.query_ends[i]}"
        f"\ttarget_batch_end={res.target_ends[i]}\n"
        for i in range(len(res.scores))
    )


@pytest.mark.parametrize("case", ["score", "score2"])
def test_golden_logs(case):
    """The port reproduces the reference-format golden logs line by
    line (score2: -w 15 -z -1 drives empty-slice termination)."""
    if case == "score":
        cfg, files = CFG, ("query.fasta", "target.fasta")
    else:
        cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                          band_width=15, z_threshold=-1)
        files = ("query2.fasta", "target2.fasta")
    with open(os.path.join(GOLDEN, f"{case}.log")) as f:
        expected = f.read()
    assert _golden_lines(cfg, *files) == expected


def test_empty_batch_and_empty_sequence():
    engine = AlignEngine(CFG, device="cpu")
    res = engine.align([])
    assert len(res.scores) == 0 and res.n_buckets == 0
    q = encode_padded("ACGT")
    with pytest.raises(ValueError, match="empty sequence"):
        engine.align([(q, q, 0, 4)])
    with pytest.raises(ValueError, match="empty sequence"):
        engine.align([(q, q, 4, 0)])


def test_packing_limit_warning(rng):
    """Over-range pairs warn once per call and still give the oracle's
    (degraded) results."""
    cfg = AlignConfig(match=800, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=751)
    pairs = []
    for _ in range(2):
        q = random_seq(rng, 48)
        tc = encode_padded(mutate(rng, q))
        pairs.append((encode_padded(q), tc, 48, len(tc)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = AlignEngine(cfg, device="cpu").align(pairs)
    msgs = [x for x in w if "16-bit" in str(x.message)]
    assert len(msgs) == 1 and "2 pair(s)" in str(msgs[0].message)
    _assert_oracle(res, pairs, cfg)


def test_unported_routes_raise(rng):
    """No route of `EngineConfig` raises any more: colband, the last one
    that did, now routes int16-safe banded buckets to the banded column
    sweep and gives the antidiagonal kernel's results."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      z_threshold=400, band_width=63)
    enc = _mixed(rng, 12, 100, 400, 0.02)
    on = AlignEngine(cfg, EngineConfig(colband=True), device="cpu").align(enc)
    assert on.routes == ["colband"] * on.n_buckets
    off = AlignEngine(cfg, EngineConfig(colsweep=False),
                      device="cpu").align(enc)
    assert off.routes == ["anti"] * off.n_buckets
    for f in FIELDS:
        assert (getattr(on, f) == getattr(off, f)).all(), f
    _assert_oracle(on, enc, cfg)


@pytest.mark.parametrize("mode", ["device", "host"])
def test_traceback_returns_cigars(mode):
    """traceback=True gives one CIGAR per pair in both modes; the device
    mode routes every bucket to the walk, the host mode keeps the score
    path's routes."""
    q = encode_padded("ACGTTGCAACGATCCTAGGA")
    t = encode_padded("ACGTTGCAACTGATCCTAGGA")
    engine = AlignEngine(CFG, EngineConfig(traceback_mode=mode),
                         device="cpu")
    res = engine.align([(q, q, 8, 8), (q, t, 20, 21)], traceback=True)
    assert res.cigars == ["8M", "10M1D10M"]
    assert res.routes == (["walk"] if mode == "device" else ["colsweep"])
    assert engine.align([], traceback=True).cigars == []
    assert engine.align([(q, q, 8, 8)]).cigars is None
    # any other mode runs host mode, as the JAX engine does
    other = AlignEngine(CFG, EngineConfig(traceback_mode="gpu"),
                        device="cpu").align([(q, q, 8, 8)], traceback=True)
    assert other.cigars == ["8M"] and other.routes == ["colsweep"]


def test_host_kernel_ms_excludes_traceback(monkeypatch):
    """In host mode `kernel_ms` stops before the host re-DP, as the JAX
    engine's clock does (agatha_tpu/engine.py `_collect`)."""
    import agatha_tpu_torch.engine as eng

    slept = 0.4
    real = eng.traceback_all

    def slow(*args, **kwargs):
        time.sleep(slept)
        return real(*args, **kwargs)

    monkeypatch.setattr(eng, "traceback_all", slow)
    q = encode_padded("ACGTTGCAACGATCCTAGGA")
    engine = AlignEngine(CFG, EngineConfig(traceback_mode="host"),
                         device="cpu")
    engine.align([(q, q, 20, 20)])  # warm
    t0 = time.perf_counter()
    res = engine.align([(q, q, 20, 20)], traceback=True)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert res.cigars == ["20M"]
    assert wall_ms >= slept * 1e3
    assert res.kernel_ms < wall_ms - slept * 1e3 * 0.9


@pytest.mark.parametrize("mode", ["gpu", ""])
def test_unknown_traceback_mode_runs_host_mode(rng, mode):
    """An unknown `traceback_mode` gives the JAX engine's CIGARs (its
    host mode) and the score path's routes."""
    enc = _mixed(rng, 12, 20, 300, 0.02)
    ecfg = EngineConfig(aligns_per_batch=8, traceback_mode=mode,
                        use_all_devices=False)
    ref = JaxEngine(CFG, ecfg, interpret=True).align(enc, traceback=True)
    res = AlignEngine(CFG, config_from(ecfg), device="cpu").align(
        enc, traceback=True)
    assert res.cigars == ref.cigars and any(res.cigars)
    assert "walk" not in res.routes
    for f in FIELDS:
        assert (getattr(res, f) == getattr(ref, f)).all(), f


@pytest.mark.parametrize("traceback", [False, True])
def test_empty_batch_routes_none(traceback):
    """An empty batch gives `routes=None`, as the JAX engine's result
    (whose field default is None)."""
    res = AlignEngine(CFG, device="cpu").align([], traceback=traceback)
    ref = JaxEngine(CFG, EngineConfig(use_all_devices=False),
                    interpret=True).align([], traceback=traceback)
    assert res.routes is None and ref.routes is None
    assert res.cigars == ref.cigars


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlignEngine(CFG, device="cuda")


def test_default_device_is_the_card():
    """With no device given the engine runs on the card; without one it
    raises as device="cuda" does."""
    if torch.cuda.is_available():
        assert AlignEngine(CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        AlignEngine(CFG)


# -- the list encoder (native/encoder.cpp) and its recycled slabs ----------

ENCODE_CASES = ["short", "long", "bytes", "mixed", "lower_n", "non_ascii",
                "one_pair", "bytearray"]


def _encode_case(case, seed=11):
    """SeqPairs of one parity case; every op on each side (16 pairs cycle
    through the 4 x 4 combinations)."""
    from agatha_tpu_torch.io.fasta import SeqPair

    rng = np.random.default_rng(seed)
    alphabet = list("ACGTNacgtn" if case == "lower_n" else "ACGT")

    def seqs(n, lo, hi):
        return ["".join(rng.choice(alphabet, int(rng.integers(lo, hi))))
                for _ in range(n)]

    n, lo, hi = {"long": (5, 10_000, 15_001),
                 "one_pair": (1, 1, 301)}.get(case, (48, 1, 301))
    qs, ts = seqs(n, lo, hi), seqs(n, lo, hi)
    if case == "non_ascii":
        # 2-, 3- and 4-byte UTF-8 characters among the bases
        qs = [s[:3] + "é" + s[3:] + "→" for s in qs]
        ts = [s + "\U0001f9ec" + s[:2] for s in ts]
    conv = {"bytes": lambda i, s: s.encode(),
            "mixed": lambda i, s: s.encode() if i % 2 else s,
            "bytearray": lambda i, s: bytearray(s.encode())}.get(
                case, lambda i, s: s)
    return [SeqPair(conv(i, q), conv(i + 1, t), i % 4, (i // 4) % 4)
            for i, (q, t) in enumerate(zip(qs, ts))]


def _batch_encoder_rows(seqs, ops):
    """The batch encoder (native/packer.cpp) on a side: (rows, lens)."""
    from agatha_tpu_torch import native

    blobs = [s.encode() if isinstance(s, str) else bytes(s) for s in seqs]
    stride = max(8, -(-max(len(b) for b in blobs) // 8) * 8)
    return native.encode_batch(blobs, np.array(ops, np.uint8), stride)


@pytest.mark.parametrize("unavailable", ["", "encoder", "both"])
@pytest.mark.parametrize("case", ENCODE_CASES)
def test_list_encoder_matches_batch_encoder(monkeypatch, case, unavailable):
    """`encode_pairs` gives the batch encoder's codes and lengths byte
    for byte, for every op on each side, str and bytes, lower case and
    N, non-ASCII str (its UTF-8 bytes), one pair; as it does with the
    list encoder unavailable, or both native libraries (NumPy per pair,
    whose ASCII-only decode the non-ASCII case is not given).  A batch
    that takes the older path counts ``encode.fallback``."""
    from agatha_tpu_torch import native, trace

    if unavailable == "both" and case == "non_ascii":
        unavailable = "encoder"
    assert native.encoder_available() and native.available()
    if unavailable:
        monkeypatch.setattr(native, "_enc", None)
        monkeypatch.setattr(native, "_enc_tried", True)
    if unavailable == "both":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    pairs = _encode_case(case)
    trace.drain()
    trace.enable()
    try:
        enc = AlignEngine(CFG, device="cpu").encode_pairs(pairs)
    finally:
        trace.disable()
    counts = {k: v for (_c, k), v in trace.drain()[1].items()}
    took_old = bool(unavailable) or case == "bytearray"
    assert counts == ({"encode.fallback": 1} if took_old
                      else {"encode.slab_new": 2})
    monkeypatch.undo()
    for side in (0, 1):
        seqs = [(p.query, p.target)[side] for p in pairs]
        ops = [(p.query_op, p.target_op)[side] for p in pairs]
        rows, lens = _batch_encoder_rows(seqs, ops)
        assert [e[2 + side] for e in enc] == lens.tolist()
        for i, e in enumerate(enc):
            codes = e[side]
            pad = -(-int(lens[i]) // 8) * 8
            assert codes.dtype == np.uint8 and codes.ndim == 1
            assert codes.flags.c_contiguous and codes.size == pad
            assert codes.tobytes() == rows[i, :pad].tobytes(), (side, i)


def test_encode_recycles_a_slab_only_once_its_views_are_gone():
    """Batch A held while B encodes: A's codes stay as they were and B
    takes new slabs; with A dropped, C takes A's.  At most ``keep``
    slabs stay free."""
    from agatha_tpu_torch import trace

    engine = AlignEngine(CFG, device="cpu")
    pa, pb, pc = (_encode_case("short", seed) for seed in (1, 2, 3))

    def encode(pairs):
        trace.drain()
        trace.enable()
        try:
            enc = engine.encode_pairs(pairs)
        finally:
            trace.disable()
        return enc, {k: v for (_c, k), v in trace.drain()[1].items()}

    a, _ = encode(pa)
    before = [(q.tobytes(), t.tobytes()) for q, t, _q, _t in a]
    b, counts_b = encode(pb)
    assert [(q.tobytes(), t.tobytes()) for q, t, _q, _t in a] == before
    assert counts_b == {"encode.slab_new": 2}
    del a
    c, counts_c = encode(pc)
    assert counts_c == {"encode.slab_reused": 2}
    for got, pairs in ((b, pb), (c, pc)):
        ref = engine._encode_rows(pairs)
        assert [(q.tobytes(), t.tobytes(), x, y) for q, t, x, y in got] \
            == [(q.tobytes(), t.tobytes(), x, y) for q, t, x, y in ref]
    del got

    held = [encode(pa)[0] for _ in range(4)]
    del b, c, held
    assert len(engine._slabs._free) == 12
    d, _ = encode(pa)
    assert 0 < len(engine._slabs._free) <= engine._slabs.keep


def test_stream_chunks_in_flight_keep_their_codes():
    """`align_stream` with three chunks in flight, each encoded into
    slabs while the chunks ahead of it are still held, scores as `align`
    does chunk by chunk; the later chunks reuse the first ones' slabs."""
    from agatha_tpu_torch import EngineConfig, trace
    from agatha_tpu_torch.io.fasta import SeqPair

    rng = np.random.default_rng(5)
    pairs = []
    for i in range(80):
        q = random_seq(rng, int(rng.integers(40, 120)))
        t = mutate(rng, q) if i % 2 else random_seq(rng, 60)
        pairs.append(SeqPair(q, t, 0, 0))
    ecfg = EngineConfig(aligns_per_batch=16)
    trace.drain()
    trace.enable()
    try:
        chunks = list(AlignEngine(CFG, ecfg, device="cpu").align_stream(
            iter(pairs), max_in_flight=3))
    finally:
        trace.disable()
    counts = {}
    for (_c, k), v in trace.drain()[1].items():
        counts[k] = counts.get(k, 0) + v
    assert counts == {"encode.slab_new": 6, "encode.slab_reused": 4}
    ref = AlignEngine(CFG, ecfg, device="cpu")
    assert len(chunks) == 5
    for k, got in enumerate(chunks):
        exp = ref.align_pairs(pairs[16 * k: 16 * (k + 1)])
        for f in FIELDS:
            assert (getattr(got, f) == getattr(exp, f)).all(), (k, f)


def test_slab_free_list_holds_under_threads():
    """Sixteen threads take slabs from one free list, fill them, take
    another, and check the first before dropping both (their finalizers
    giving them back on those threads), with a short switch interval: no
    slab is ever handed to two holders at once, and no slab is on the
    free list twice."""
    import sys
    import threading

    from agatha_tpu_torch.engine import _Slabs

    slabs = _Slabs()
    bad = []

    def work(k):
        rng = np.random.default_rng(k)
        for _ in range(100):
            a = slabs.take(int(rng.integers(1, 200_000)))
            a[:] = k
            b = slabs.take(int(rng.integers(1, 200_000)))
            b[:] = 255 - k
            if (a != k).any():
                bad.append(k)
            del a, b

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert len({id(b) for b in slabs._free}) == len(slabs._free) > 0
