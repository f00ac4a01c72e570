"""Port's colband route vs the JAX package (bit-exact, tolerance 0).

The port's copies of the host functions of `agatha_tpu.ops.colband` are
held against the originals; the plain PyTorch version of the banded
column-sweep kernel (B7) against the JAX `align_bucket_colband` and
`align_bucket` (Pallas interpret mode) and the oracle `align_one_sweep`;
the engine's buckets, routes and results with `colband=True` against the
JAX engine's.  Every output is an integer, so every comparison is exact.
The CUDA kernel and the probe instances are compared with their plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from agatha_tpu.config import AlignConfig as JaxAlignConfig
from agatha_tpu.config import EngineConfig as JaxEngineConfig
from agatha_tpu.engine import AlignEngine as JaxEngine
from agatha_tpu.ops import colband as jcb
from agatha_tpu.ops.kernel import align_bucket as jax_align_bucket
from agatha_tpu.ops.packing import encode_padded
from agatha_tpu.ops.sweep import align_one_sweep
from agatha_tpu_torch import engine as tengine
from agatha_tpu_torch.config import config_from
from agatha_tpu_torch.engine import AlignEngine
from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.ops import colband as tcb
from agatha_tpu_torch.ops import kernel as tk
from agatha_tpu_torch.probes import colband_bench, colband_probe

from .conftest import mutate, random_seq
from .test_torch_wave_probe import original

torch.set_num_threads(1)

# the configurations of tests/test_colband.py
JAX_CONFIGS = [
    JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                   slice_width=3, z_threshold=400, band_width=751),
    JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                   slice_width=3, z_threshold=400, band_width=31),
    JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                   slice_width=3, z_threshold=20, band_width=101),
    JaxAlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                   slice_width=5, z_threshold=150, band_width=55),
    JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                   slice_width=1, z_threshold=100, band_width=63),
    JaxAlignConfig(match=3, mismatch=5, gap_open=4, gap_extend=2,
                   slice_width=4, z_threshold=800, band_width=127),
]
CFG_IDS = ["canonical", "bw31", "z20-bw101", "m2x3q5r1s5", "s1-bw63",
           "m3x5-bw127"]
BW63 = JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=63)
FIELDS = ("scores", "query_ends", "target_ends", "diags")
EMPTY_SLICE_SHAPES = [(16, 600), (600, 16), (200, 200), (64, 257),
                      (1, 100), (100, 1), (300, 33), (33, 300)]


def _pairs(rng, n=30, lo=8, hi=400):
    out = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(lo, hi)), 0.03)
        if i % 3 == 0:
            t = random_seq(rng, int(rng.integers(lo, hi)), 0.03)
        else:
            t = mutate(rng, q)
        out.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return out


def _unrelated(rng, shapes):
    return [(encode_padded(random_seq(rng, ql, 0.05)),
             encode_padded(random_seq(rng, rl, 0.05)), ql, rl)
            for ql, rl in shapes]


def _bucket(pairs, cfg):
    """Host wire and CPU tensors of a bucket."""
    host = tk.build_bucket_arrays(pairs, cfg)
    return host, tuple(torch.from_numpy(a) for a in host)


# -- the copied host functions ------------------------------------------------

@pytest.mark.parametrize("jcfg", JAX_CONFIGS, ids=CFG_IDS)
def test_host_functions_match_jax(rng, jcfg):
    """colband_shapes, chain_scalars, colband_eligible and
    first_empty_slice equal the JAX package's on random metas."""
    cfg = config_from(jcfg)
    for trial in range(12):
        gb = int(rng.integers(1, 40))
        hi = (60, 800, 5000)[trial % 3]
        meta = rng.integers(1, hi, size=(gb, 2)).astype(np.int32)
        if trial % 4 == 0:
            meta[: gb // 2, 0] = 1   # extreme aspect ratios: empty slices
        assert tcb.colband_shapes(meta, cfg) == jcb.colband_shapes(meta, jcfg)
        assert np.array_equal(tcb.chain_scalars(meta, cfg),
                              jcb.chain_scalars(meta, jcfg))
        for ql, rl in meta[:6]:
            assert (tcb.first_empty_slice(int(ql), int(rl), cfg)
                    == jcb.first_empty_slice(int(ql), int(rl), jcfg))
    meta = np.ones((1, 2), np.int32)
    for safe in (True, False):
        assert (tcb.colband_eligible(meta, cfg, safe)
                == jcb.colband_eligible(meta, jcfg, safe))
    assert tcb.chain_scalars(np.zeros((0, 2), np.int32), cfg).shape == (8, 0)


@pytest.mark.parametrize("bw, ok", [(751, True), (2001, True), (2032, True),
                                    (2033, False), (4000, False)])
def test_eligible_window_bound_matches_jax(bw, ok):
    jcfg = JaxAlignConfig(band_width=bw)
    meta = np.ones((1, 2), np.int32)
    assert jcb.colband_eligible(meta, jcfg, True) == ok
    assert tcb.colband_eligible(meta, config_from(jcfg), True) == ok


@pytest.mark.parametrize("jcfg", JAX_CONFIGS[1:4], ids=CFG_IDS[1:4])
def test_numpy_contract_matches_oracle_no_holes(rng, jcfg):
    """The port's align_one_colband_np equals align_one_sweep and the
    JAX package's contract, and no column's computed set has a hole (the
    condition of the kernel's plain-weight E)."""
    cfg = config_from(jcfg)
    holes = []
    pairs = _pairs(rng, n=12) + _unrelated(rng, EMPTY_SLICE_SHAPES[:4])
    for qc, tc, ql, rl in pairs:
        got = tcb.align_one_colband_np(qc, tc, ql, rl, cfg,
                                       collect_holes=holes)
        assert got[:3] == tuple(align_one_sweep(qc, tc, ql, rl, jcfg))
        assert got == jcb.align_one_colband_np(qc, tc, ql, rl, jcfg)
    assert not holes


# -- the plain version against the Pallas kernel and the oracle -------------

@pytest.mark.parametrize("case", ["bw63-mixed", "bw31-z20-empty-slices"])
def test_colband_torch_matches_jax_interpret(rng, case):
    """Port (CPU) == JAX align_bucket_colband in interpret mode == JAX
    align_bucket in interpret mode, all four columns, on the two buckets
    of tests/test_colband.py; and the oracle on the first three."""
    if case == "bw63-mixed":
        jcfg = BW63
        pairs = _pairs(rng, n=24, lo=8, hi=300)
    else:
        jcfg = JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                              slice_width=3, z_threshold=20, band_width=31)
        pairs = _unrelated(rng, EMPTY_SLICE_SHAPES)
    cfg = config_from(jcfg)
    host, args = _bucket(pairs, cfg)
    got = tcb.align_bucket_colband(*args, cfg).numpy()
    ref = np.asarray(jcb.align_bucket_colband(*host, jcfg, interpret=True))
    anti = np.asarray(jax_align_bucket(*host, jcfg, interpret=True))
    assert (got == ref).all(), np.argwhere(got != ref)
    assert (got == anti).all(), np.argwhere(got != anti)
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(got[p, :3]) == tuple(
            align_one_sweep(qc, tc, ql, rl, jcfg)), p


def test_colband_torch_rolling_window_matches_oracle(rng):
    """bw 751 with 1200-2600 bp pairs: the window rolls (gB > gA).
    Against the oracle and the port's antidiagonal plain version."""
    jcfg = JAX_CONFIGS[0]
    cfg = config_from(jcfg)
    pairs = []
    for i in range(6):
        q = random_seq(rng, int(rng.integers(1200, 2600)), 0.01)
        t = (mutate(rng, q) if i % 3 else
             random_seq(rng, int(rng.integers(1200, 2600)), 0.01))
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    host, args = _bucket(pairs, cfg)
    shapes = tcb.colband_shapes(host[0], cfg)
    assert shapes[0] == 1536 and shapes[5] > shapes[4]   # RW; gB > gA
    got = tcb.align_bucket_colband(*args, cfg, shapes=shapes).numpy()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(got[p, :3]) == tuple(
            align_one_sweep(qc, tc, ql, rl, jcfg)), p
    assert (got == tk.align_bucket_torch(*args, cfg).numpy()).all()


@pytest.mark.parametrize("jcfg", [JAX_CONFIGS[3], JAX_CONFIGS[5]],
                         ids=[CFG_IDS[3], CFG_IDS[5]])
def test_colband_torch_any_gb_all_n_and_padding(rng, jcfg):
    """GB not a multiple of 8, all-N pairs and 1x1 padding rows, a second
    and third scoring config, against the oracle and the antidiagonal
    plain version."""
    cfg = config_from(jcfg)
    pairs = [(encode_padded("N" * 50), encode_padded("ACGT" * 15), 50, 60),
             (encode_padded("N" * 33), encode_padded("N" * 33), 33, 33),
             (encode_padded("A"), encode_padded("A"), 1, 1)]
    pairs += _pairs(rng, n=8, lo=1, hi=420)
    host, args = _bucket(pairs, cfg)
    n = 11
    sub = tuple(a[:n].contiguous() for a in args)
    got = tcb.align_bucket_colband(*sub, cfg).numpy()
    assert got.shape == (n, 4)
    assert (got == tk.align_bucket_torch(*args, cfg).numpy()[:n]).all()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(got[p, :3]) == tuple(
            align_one_sweep(qc, tc, ql, rl, jcfg)), p


def test_colband_torch_chain_runs_to_end_p_past_the_padded_extent(rng):
    """Slice width 4 and ~250 bp pairs give i_end8 = 512 = R8pad + Qpad,
    so the chain's end cap end_p = 520 lies past the padded extent: the
    chain still replays diagonals 512-519 (no cell writes them), as the
    JAX package's colband and antidiagonal kernels (interpret mode), the
    port's antidiagonal plain version and the NumPy contract do."""
    jcfg = JaxAlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                          slice_width=4, z_threshold=400, band_width=63)
    cfg = config_from(jcfg)
    pairs = []
    for n in (250, 252, 255):
        q = random_seq(rng, n)
        t = "".join("ACGT"[int(rng.integers(0, 4))] if rng.random() < 0.05
                    else ch for ch in q)
        pairs.append((encode_padded(q), encode_padded(t), n, n))
    host, args = _bucket(pairs, cfg)
    shapes = tcb.colband_shapes(host[0], cfg)
    scal = tcb.chain_scalars(host[0], cfg)
    assert (scal[4, :3] > shapes[1] + shapes[2]).all()  # end_p > R8pad + Qpad
    got = tcb.align_bucket_colband(*args, cfg).numpy()
    ref = np.asarray(jcb.align_bucket_colband(*host, jcfg, interpret=True))
    assert (got == ref).all(), (got[:3], ref[:3])
    assert (got == tk.align_bucket_torch(*args, cfg).numpy()).all()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(got[p]) == tcb.align_one_colband_np(qc, tc, ql, rl, cfg)
    assert (got[:3, 3] == scal[4, :3]).all()


def test_align_bucket_colband_checks_its_inputs(rng):
    """Wrong dtype, non-contiguous tensors and shapes outside the wire
    or the gate raise before any sweep."""
    cfg = config_from(BW63)
    host, args = _bucket(_pairs(rng, n=8, lo=8, hi=200), cfg)
    meta, tcodes, qfwd = args
    shapes = tcb.colband_shapes(host[0], cfg)
    scalars = torch.from_numpy(tcb.chain_scalars(host[0], cfg))
    with pytest.raises(ValueError, match="int32"):
        tcb.align_bucket_colband(meta.long(), tcodes, qfwd, cfg)
    with pytest.raises(ValueError, match="uint8"):
        tcb.align_bucket_colband(meta, tcodes.int(), qfwd, cfg)
    with pytest.raises(ValueError, match=f"GB={meta.shape[0]}"):
        tcb.align_bucket_colband(meta, tcodes[:4], qfwd, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        tcb.align_bucket_colband(meta, tcodes.t().contiguous().t(), qfwd,
                                 cfg)
    with pytest.raises(ValueError, match=rf"\(8, {meta.shape[0]}\) int32"):
        tcb.align_bucket_colband(meta, tcodes, qfwd, cfg,
                                 scalars=scalars[:5].contiguous())
    RW, R8pad, Qpad, G, gA, gB, tail, LEAD, WMAX = shapes
    for bad in ((RW + 4, R8pad, Qpad, G, gA, gB, tail, LEAD, WMAX - 4),
                (RW, R8pad, Qpad + 8, G, gA, gB, tail, LEAD, WMAX),
                (RW, R8pad, Qpad, G, gA, gB, tail, LEAD - 8, WMAX),
                (8192, 8192, Qpad, G, gA, gB, tail, LEAD, 0)):
        with pytest.raises(ValueError, match="not a colband schedule"):
            tcb.align_bucket_colband(meta, tcodes, qfwd, cfg, shapes=bad,
                                     scalars=scalars)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcb.colband_cuda(scalars, tcodes, qfwd, cfg, shapes)
    empty = tcb.align_bucket_colband(meta[:0], tcodes[:0], qfwd[:0], cfg)
    assert empty.shape == (0, 4)


# -- the engine ----------------------------------------------------------------

def _longs(rng, n=256):
    out = []
    for i in range(n):
        s = random_seq(rng, 600 + (i % 50))
        t = mutate(rng, s)
        out.append((encode_padded(s), encode_padded(t), len(s), len(t)))
    return out


def test_snap_decided_per_chunk_matches_jax(rng):
    """tests/test_engine.py test_snap_decided_per_chunk_not_per_dataset:
    long banded chunks keep the tuned split with colband off, snap to
    128 pairs with it on, and a mixed batch snaps only its short-read
    prefix; the JAX engine splits the same way."""
    cfg = config_from(BW63)
    longs = _longs(rng)
    shorts = []
    for i in range(128):
        s = random_seq(rng, 24 + (i % 17))
        t = mutate(rng, s)
        shorts.append((encode_padded(s), encode_padded(t), len(s), len(t)))
    for colband, enc, want in ((False, longs, [64] * 4),
                               (True, longs, [128] * 2),
                               (False, shorts + longs, [128, 96, 96, 64])):
        jecfg = JaxEngineConfig(target_buckets=4, colband=colband,
                                use_all_devices=False)
        eng = AlignEngine(cfg, config_from(jecfg), device="cpu")
        sizes = [len(b.indices) for b in eng.iter_buckets(enc)]
        assert sizes == want
        jsizes = [len(b.indices) for b in
                  JaxEngine(BW63, jecfg, interpret=True).iter_buckets(enc)]
        assert sizes == jsizes


def _banded_batch(rng, n=40):
    enc = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(100, 400)), 0.02)
        t = mutate(rng, q) if i % 2 else random_seq(
            rng, int(rng.integers(100, 400)), 0.02)
        enc.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return enc


def test_engine_routes_colband_and_matches_jax(rng, monkeypatch):
    """tests/test_engine.py test_engine_routes_colband_and_matches: long
    banded pairs route to the banded column sweep (spy-asserted), equal
    the antidiagonal run in all four fields, and equal the JAX engine
    with colband on: buckets, routes and results."""
    cfg = config_from(BW63)
    enc = _banded_batch(rng)
    calls = []
    real = tengine.align_bucket_colband

    def spy(meta, *a, **kw):
        assert kw["shapes"] is not None and kw["scalars"] is not None
        calls.append(int(meta.shape[0]))
        return real(meta, *a, **kw)

    monkeypatch.setattr(tengine, "align_bucket_colband", spy)
    jecfg = JaxEngineConfig(colband=True, use_all_devices=False)
    eng = AlignEngine(cfg, config_from(jecfg), device="cpu")
    on = eng.align(enc, per_bucket_times=True)
    assert on.routes == ["colband"] * on.n_buckets and on.n_buckets >= 1
    assert len(calls) == on.n_buckets and len(on.bucket_ms) == on.n_buckets
    off = AlignEngine(cfg, config_from(JaxEngineConfig(
        colband=False, colsweep=False)), device="cpu").align(enc)
    assert off.routes == ["anti"] * off.n_buckets
    jeng = JaxEngine(BW63, jecfg, interpret=True)
    jon = jeng.align(enc)
    assert on.routes == jon.routes
    for a, b in zip(eng.iter_buckets(enc), jeng.iter_buckets(enc)):
        assert (a.indices == b.indices).all()
        assert a.meta.tobytes() == b.meta.tobytes()
    for f in FIELDS:
        assert (getattr(on, f) == getattr(off, f)).all(), f
        assert (getattr(on, f) == getattr(jon, f)).all(), f


def test_engine_colsweep_before_colband_and_not_in_traceback(rng,
                                                             monkeypatch):
    """With both on, a bucket the full column sweep can take goes there;
    an int16-unsafe bucket stays on the antidiagonal kernel; and device
    traceback never routes to colband."""
    canon = config_from(JAX_CONFIGS[0])
    both = config_from(JaxEngineConfig(colband=True))
    shorts = _pairs(rng, n=12, lo=20, hi=100)
    res = AlignEngine(canon, both, device="cpu").align(shorts)
    assert res.routes == ["colsweep"]

    unsafe = config_from(JaxAlignConfig(match=1, mismatch=4, gap_open=6,
                                        gap_extend=2, z_threshold=-1,
                                        band_width=63))
    enc = _banded_batch(rng, n=6)
    assert AlignEngine(unsafe, both, device="cpu").align(enc).routes == [
        "anti"]

    def boom(*a, **kw):
        raise AssertionError("colband dispatched under device traceback")

    monkeypatch.setattr(tengine, "align_bucket_colband", boom)
    cfg = config_from(BW63)
    tb = AlignEngine(cfg, both, device="cpu").align(enc, traceback=True)
    assert tb.routes == ["walk"] * tb.n_buckets
    assert len(tb.cigars) == len(enc) and any(tb.cigars)


# -- the probes -----------------------------------------------------------------

@pytest.mark.parametrize("switches", [
    {}, {"with_chain": False}, {"n_prefix": 1}, {"with_ring": False},
    {"n_prefix": 1, "with_ring": False, "with_chain": False},
], ids=["full", "no-chain", "no-prefix", "no-ring", "bare"])
def test_probe_plain_version(switches):
    """P2's plain version: deterministic, int32 (4, G * 128), the same
    for every pair, and with the chain off it returns `prev` unchanged.
    (The next test holds it against the Pallas probe in interpret mode;
    the CUDA instances are held against it on the card.)"""
    meta, prev = colband_probe.probe_inputs(1, 64, "cpu")
    prev = prev + torch.arange(4, dtype=torch.int32)[:, None]
    out, state = colband_probe.colband_probe_torch(
        meta, prev, 384, 64, return_state=True, **switches)
    again = colband_probe.colband_probe(meta, prev, 384, 64, **switches)
    assert out.dtype == torch.int32 and out.shape == (4, 128)
    assert torch.equal(out, again)
    assert (out == out[:, :1]).all()
    assert state.shape == (3 * 384 + 16, 128)
    if not switches.get("with_chain", True):
        assert torch.equal(out, prev)
    else:
        assert not torch.equal(out, prev)
    ring = state[2 * 384:]
    assert (ring > np.iinfo(np.int32).min).any() == switches.get(
        "with_ring", True)


@pytest.mark.parametrize("switches", [
    {}, {"with_chain": False}, {"n_prefix": 1}, {"with_ring": False},
    {"n_prefix": 1, "with_ring": False, "with_chain": False},
], ids=["full", "no-chain", "no-prefix", "no-ring", "bare"])
def test_probe_plain_version_equals_pallas_original(switches):
    """P2's plain version == scripts/colband_probe.py:make_kernel in
    interpret mode, exactly: RW 384, 64 columns, one 128-pair block,
    ragged column counts and a random non-zero `prev`."""
    orig = original("colband_probe")
    RW, ncols, qres = 384, 64, 64
    meta, _prev = colband_probe.probe_inputs(1, ncols, "cpu")
    meta[0, 1::3] = ncols - 13
    meta[0, 2::3] = 40
    prev = torch.from_numpy(np.random.default_rng(3).integers(
        -2**31, 2**31, (4, orig.LN), dtype=np.int64).astype(np.int32))
    n_prefix = switches.get("n_prefix", colband_probe.full_prefix(RW))
    kernel = orig.make_kernel(RW, ncols, qres,
                              switches.get("with_chain", True), n_prefix,
                              switches.get("with_ring", True))

    def spec(rows):
        return pl.BlockSpec((rows, orig.LN), lambda g: (0, g),
                            memory_space=pltpu.VMEM)

    ref = pl.pallas_call(
        kernel, grid=(1,), in_specs=[spec(2), spec(qres), spec(4)],
        out_specs=spec(4),
        out_shape=jax.ShapeDtypeStruct((4, orig.LN), jnp.int32),
        interpret=True,
    )(meta.numpy(), np.zeros((qres, orig.LN), np.int32), prev.numpy())
    out = colband_probe.colband_probe_torch(meta, prev, RW, ncols,
                                            **switches)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_probe_cuda_wrapper_checks_its_inputs():
    meta, prev = colband_probe.probe_inputs(1, 64, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        colband_probe.colband_probe_cuda(meta, prev, 384, 64)
    with pytest.raises(ValueError, match="int32"):
        colband_probe.colband_probe_cuda(meta.long(), prev, 384, 64)
    assert _nvcc.launched("probe.colband") == 0


def test_probe_cuda_wrapper_takes_the_rows_of_colband_rows():
    """`rows=None` takes the R that `colband_rows` gives B7 at the window
    (R = 8 at the original's RW 1568, R = 4 at 1536, R = 2 at 768 and
    384); an R whose block (RW / R row threads and the chain warp) passes
    its instance's launch bound is refused with ValueError before the
    device check, and one that fits reaches it."""
    for rw in range(8, 4097, 8):
        assert colband_probe.probe_rows(rw) == tcb.colband_rows(rw), rw
    assert [colband_probe.probe_rows(rw) for rw in (384, 768, 1536, 1568)] \
        == [2, 2, 4, 8]
    assert [colband_probe.probe_rows(rw, r) for rw, r in
            ((1984, 2), (1536, 4), (4096, 8), (1568, 8))] == [2, 4, 8, 8]
    meta, prev = colband_probe.probe_inputs(1, 64, "cpu")
    for rw, rows in ((1992, 2), (2048, 2), (1544, 4), (1568, 4), (64, 3)):
        with pytest.raises(ValueError, match="rows a thread"):
            colband_probe.colband_probe_cuda(meta, prev, rw, 64, rows=rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        colband_probe.colband_probe_cuda(meta, prev, 1536, 64, rows=4)
    assert _nvcc.launched("probe.colband") == 0


def test_bench_harness_stages_a_bucket(rng):
    """P1's staging: the scalars, wire and shapes the kernel takes, and
    the column count its slope divides by."""
    cfg = config_from(BW63)
    host, _args = _bucket(_pairs(rng, n=8, lo=8, hi=200), cfg)
    scalars, tcodes, qfwd, shapes = colband_bench.stage_bucket(
        *host, cfg, device="cpu")
    assert shapes == tcb.colband_shapes(host[0], cfg)
    assert np.array_equal(scalars.numpy(), tcb.chain_scalars(host[0], cfg))
    assert tcodes.numpy().tobytes() == host[1].tobytes()
    assert colband_bench.swept_columns(scalars, shapes) == int(
        host[0][:, 0].max())
    got = tcb.colband_torch(scalars, tcodes, qfwd, cfg, shapes)
    assert torch.equal(got, tcb.align_bucket_colband(
        *(torch.from_numpy(a) for a in host), cfg))


def test_colband_rows_rule_fits_every_window():
    """`colband_rows`: the fewest rows a thread that keep a block within
    384 row threads (the instances measured fastest at RW 544 at R = 2,
    1536 at R = 4, 2032 at R = 8; at RW 288 R = 2 was 0.7% behind R =
    4), and every window the gate admits gets an instance whose block
    fits its launch bound (`max_threads`: 1024 at most, 416 for R =
    4)."""
    assert [tcb.colband_rows(rw) for rw in (288, 544, 1536, 2032, 4048)] \
        == [2, 2, 4, 8, 8]
    assert [tcb.max_threads(r) for r in tcb.COLBAND_ROWS] == [1024, 416, 544]
    for rw in range(8, 4097, 8):
        rows = tcb.colband_rows(rw)
        assert tcb.block_threads(rw, rows) <= tcb.max_threads(rows), rw
        assert rw // rows <= tcb.COLBAND_ROW_THREADS or rows == 8, rw


def test_bound_probe_covers_the_rule_and_reads_ptxas():
    """A bound of 416 threads (R = 4's launch bound) takes every block
    the rule gives R = 2 or 4, and `kernel_registers` reads each B7
    instance's registers and spills from a ptxas report (other kernels
    left out)."""
    bound = tcb.COLBAND_ROW_THREADS + 32
    for rw in range(8, 4097, 8):
        rows = tcb.colband_rows(rw)
        if rows < 8:
            assert tcb.block_threads(rw, rows) <= bound, rw
    entry = ("ptxas info    : Compiling entry function '_ZN4_GLOBAL_{}' "
             "for 'sm_90a'\n"
             "    0 bytes stack frame, {} bytes spill stores, 0 bytes "
             "spill loads\n"
             "ptxas info    : Used {} registers, used 1 barriers\n")
    log = (entry.format("14colband_kernelILi4ELb0EEEvNS_6ParamsEPx", 0, 57)
           + entry.format("12probe_kernelILb1ELb1ELb1EEEvNS", 0, 83)
           + entry.format("14colband_kernelILi2ELb1EEEvNS_6ParamsEPx", 8,
                          62))
    regs = colband_bench.kernel_registers(log)
    assert sorted(regs) == ["R=2 split", "R=4"]
    assert "Used 57 registers" in regs["R=4"]
    assert "0 bytes spill stores" in regs["R=4"]
    assert "8 bytes spill stores" in regs["R=2 split"]
