"""The port's CUDA kernels on the card (skipped without a CUDA device).

Imports neither jax nor tests/conftest.py, so it runs on a machine
without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held exactly against its plain PyTorch version on the
same CUDA tensors and against the NumPy oracle, and the engine on the
card against the engine on the CPU (score path and traceback).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from agatha_tpu_torch import (
    AlignConfig,
    AlignEngine,
    EngineConfig,
    align_one_sweep,
    make_workload,
)
from agatha_tpu_torch.io.fasta import write_fasta
from agatha_tpu_torch.ops import _nvcc, colband, colsweep, kernel, walk
from agatha_tpu_torch.ops.packing import encode_padded
from agatha_tpu_torch.ops.traceback import cigar_to_pairs, score_cigar
from agatha_tpu_torch.parallel import sharding
from agatha_tpu_torch.probes import (
    colband_bench,
    colband_probe,
    skew_probe,
    wave_probe,
)

pytestmark = pytest.mark.cuda

CANON = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=400, band_width=751)
CFGS = [
    CANON,
    AlignConfig(z_threshold=-1, band_width=50, slice_width=1),
    AlignConfig(band_width=10, z_threshold=20, slice_width=2),
    # windowed at these lengths; bw 36 is the strict-margin case
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                band_width=60, z_threshold=200),
    AlignConfig(band_width=36, z_threshold=150),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _pairs(seed, n, lo, hi):
    """Half homologous (10% substitutions), half unrelated, 1% N."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.choice(np.array([1, 3, 4, 7], np.uint8),
                       int(rng.integers(lo, hi)))
        q[rng.random(q.size) < 0.01] = 14
        if i % 2 == 0:
            t = q.copy()
            sub = rng.random(t.size) < 0.1
            t[sub] = rng.choice(np.array([1, 3, 4, 7], np.uint8), sub.sum())
        else:
            t = rng.choice(np.array([1, 3, 4, 7], np.uint8),
                           int(rng.integers(lo, hi)))
        ql, rl = q.size, t.size
        qc = np.concatenate([q, np.full(-ql % 8, 14, np.uint8)])
        tc = np.concatenate([t, np.full(-rl % 8, 14, np.uint8)])
        out.append((qc, tc, ql, rl))
    return out


@pytest.mark.parametrize("cfg", CFGS)
def test_kernel_equals_plain_and_oracle(cuda, cfg):
    pairs = _pairs(7, 16, 1, 1000)
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    _nvcc.launches.clear()
    got = kernel.align_bucket(*args, cfg)
    assert _nvcc.launches["antidiag.score"] == 1
    ref = kernel.align_bucket_torch(*args, cfg)
    assert torch.equal(got, ref)
    out = got.cpu().numpy()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(out[p, :3]) == tuple(align_one_sweep(qc, tc, ql, rl,
                                                          cfg)), p


def test_kernel_wide_window(cuda):
    """bw 2001 (the ONT band): a 2304-row window, so threads stride over
    more than one row each and the state needs more than 48 KB of
    shared memory."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      band_width=2001, z_threshold=400)
    pairs = _pairs(5, 4, 2400, 3000)
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    assert 2 * tcodes.shape[1] > kernel.window_width(cfg) > 2048
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    got = kernel.align_bucket(*args, cfg)
    assert torch.equal(got, kernel.align_bucket_torch(*args, cfg))
    out = got.cpu().numpy()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(out[p, :3]) == tuple(align_one_sweep(qc, tc, ql, rl,
                                                          cfg)), p


def test_kernel_band_past_256_tile_rows(cuda):
    """bw 3000: 384 threads, the instance built for blocks of up to 1024
    (tile rows past 256)."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      band_width=3000, z_threshold=400)
    pairs = _pairs(6, 4, 3100, 3600)
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    assert kernel.tile_threads(cfg, 2 * tcodes.shape[1]) == 384
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    got = kernel.align_bucket(*args, cfg)
    assert torch.equal(got, kernel.align_bucket_torch(*args, cfg))
    assert kernel.occupancy(cfg, 2 * tcodes.shape[1], safe16=True) >= 1


def test_kernel_refuses_bands_past_1024_tile_rows(cuda):
    cfg = AlignConfig(band_width=8200, z_threshold=400)
    meta, tcodes, qfwd = kernel.build_bucket_arrays(_pairs(8, 8, 10, 20),
                                                    cfg, w=9216)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    _nvcc.launches.clear()
    with pytest.raises(ValueError, match="tile rows"):
        kernel.align_bucket(*args, cfg)
    assert not _nvcc.launches


# Satellite configs of tests/test_torch_tiles.py: slice widths 1-4,
# bw 36 / 50 / 60 / 751, z < 0, a second scoring config
RANDOM_CFGS = [
    AlignConfig(band_width=50, z_threshold=-1, slice_width=1),
    AlignConfig(band_width=60, z_threshold=200, slice_width=2),
    CANON,
    AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=4, z_threshold=30, band_width=60),
    AlignConfig(band_width=36, z_threshold=150),
]


def random_bucket(seed):
    """(cfg, pairs, force_strips) of seeded random bucket `seed`: 1-8
    pairs, a quarter of the small-band buckets windowed, every third on
    the strip path, every seventh with an all-N and a 1-code pair."""
    rng = np.random.default_rng(5000 + seed)
    cfg = RANDOM_CFGS[seed % len(RANDOM_CFGS)]
    windowed = seed % 4 == 0 and cfg.band_width < 100
    lo, hi = (400, 700) if windowed else (1, 260)
    pairs = _pairs(int(rng.integers(1 << 30)), int(rng.integers(1, 9)),
                   lo, hi)
    if seed % 7 == 0:
        pairs += [(np.full(40, 14, np.uint8), pairs[0][1], 33, pairs[0][3]),
                  (encode_padded("C"), pairs[0][1], 1, pairs[0][3])]
    return cfg, pairs, seed % 3 == 1


@pytest.mark.parametrize("chunk", range(8))
def test_kernel_random_buckets_equal_plain(cuda, chunk):
    """200 seeded buckets (25 per chunk): the kernel == the plain
    version, all four columns; every fifth also with flags (results,
    computed cells of the swept planes, walked words)."""
    for seed in range(25 * chunk, 25 * chunk + 25):
        cfg, pairs, strips = random_bucket(seed)
        meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
        args = tuple(torch.from_numpy(a).to(cuda)
                     for a in (meta, tcodes, qfwd))
        got = kernel.align_bucket(*args, cfg, force_strips=strips)
        ref = kernel.align_bucket_torch(*args, cfg, force_strips=strips)
        assert torch.equal(got, ref), seed
        if seed % 5:
            continue
        planes = kernel.flag_planes_needed(meta, cfg)
        out, flags = kernel.align_bucket(*args, cfg, force_strips=strips,
                                         emit_flags=True, planes=planes)
        _ref, ref_flags, mask = kernel.align_bucket_torch(
            *args, cfg, force_strips=strips, emit_flags=True,
            planes=planes, return_mask=True)
        assert torch.equal(out, ref), seed
        assert _swept_planes_equal(flags, ref_flags, out, planes, mask), seed
        vbases = torch.from_numpy(
            walk.vbase_schedule(planes, cfg, 2 * tcodes.shape[1])).to(cuda)
        assert torch.equal(walk.walk_torch(flags, vbases, out),
                           walk.walk_torch(ref_flags, vbases, ref)), seed


def test_kernel_force_strips_equals_safe16(cuda):
    meta, tcodes, qfwd = kernel.build_bucket_arrays(_pairs(3, 16, 1, 900),
                                                    CANON)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    assert torch.equal(kernel.align_bucket(*args, CANON),
                       kernel.align_bucket(*args, CANON, force_strips=True))


def test_engine_on_cuda_matches_cpu(cuda):
    enc = _pairs(11, 40, 50, 1500)
    _nvcc.launches.clear()
    res = AlignEngine(CANON, EngineConfig(colsweep=False),
                      device=cuda).align(enc, per_bucket_times=True)
    assert _nvcc.launches["antidiag.score"] == res.n_buckets
    assert len(res.bucket_ms) == res.n_buckets
    ref = AlignEngine(CANON, device="cpu").align(enc)
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert (getattr(res, f) == getattr(ref, f)).all(), f


COLSWEEP_CFGS = [
    CANON,
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3, z_threshold=20, band_width=751),
    AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=5, z_threshold=150, band_width=911),
]


@pytest.mark.parametrize("cfg", COLSWEEP_CFGS)
@pytest.mark.parametrize("lo, hi", [(1, 170), (560, 753)])
def test_colsweep_kernels_equal_plain_and_oracle(cuda, cfg, lo, hi):
    pairs = [p for p in _pairs(13, 24, lo, hi) if p[2] <= 752 and p[3] <= 752]
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    assert colsweep.bucket_eligible(meta, 2 * tcodes.shape[1],
                                    2 * qfwd.shape[1], cfg)
    shapes = colsweep.colsweep_shapes(meta, tcodes, qfwd, cfg)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    _nvcc.launches.clear()
    ring = colsweep.colsweep_sweep_cuda(*args, cfg, shapes)
    rows = colsweep.colsweep_chain_cuda(args[0], ring, cfg)
    # a register instance (R <= 1024), and the ring a view of the
    # pair-major buffer
    assert _nvcc.launches == {"colsweep.sweep.regs": 1, "colsweep.chain": 1}
    assert ring.shape == (shapes[2], meta.shape[0])
    assert ring.t().is_contiguous()
    ring_ref = colsweep.colsweep_sweep_torch(*args, cfg, shapes)
    assert torch.equal(ring, ring_ref)
    assert torch.equal(rows, colsweep.colsweep_chain_torch(args[0], ring_ref,
                                                           cfg))
    # the chain kernel on the plain version's (d_pad, GB) layout
    assert torch.equal(rows, colsweep.colsweep_chain_cuda(args[0], ring_ref,
                                                          cfg))
    assert torch.equal(rows, kernel.align_bucket(*args, cfg))
    out = rows.cpu().numpy()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(out[p, :3]) == tuple(align_one_sweep(qc, tc, ql, rl,
                                                          cfg)), p


# bands past 1023 rows: the largest register instance and the
# shared-memory one
COLSWEEP_WIDE = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                            slice_width=3, z_threshold=400, band_width=1200)


@pytest.mark.parametrize("end", ["top", "bottom"])
@pytest.mark.parametrize("k_rows", colsweep.SWEEP_REG_ROWS + (0,))
def test_colsweep_each_sweep_instance_equals_plain(cuda, k_rows, end):
    """Each instance (rows a lane; 0: shared memory) on targets at and
    beside multiples of 32 and 8 at the top of its rows or just past the
    next instance down's (the last lanes hold no row), identical pairs
    (each lane's last row holds the max of a diagonal the next lane's
    first row merges into in the same step) and GB = 7."""
    rng = np.random.default_rng(31 + k_rows)
    if end == "top":
        top = 32 * k_rows if k_rows else 1120
        rlens = (top, top - 1, top - 9, top - 25, top - 33)
    else:
        low = 32 * (k_rows - 4) + 1 if k_rows else 1025
        top = low + 33
        rlens = (top, low, low + 1, low + 8, low + 25)
    pairs = []
    for i, rl in enumerate(rlens):
        q = "".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 300))))
        t = "".join(rng.choice(list("ACGT"), size=rl))
        pairs.append((encode_padded(q), encode_padded(t), len(q), rl))
    s = "".join(rng.choice(list("ACGT"), size=top - 8))
    pairs += [(encode_padded(s), encode_padded(s), len(s), len(s))] * 2
    meta, tcodes, qfwd = (a[:7].copy() for a in kernel.build_bucket_arrays(
        pairs, COLSWEEP_WIDE))
    shapes = colsweep.colsweep_shapes(meta, tcodes, qfwd, COLSWEEP_WIDE)
    assert colsweep.sweep_rows(shapes[0]) == k_rows
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    _nvcc.launches.clear()
    ring = colsweep.colsweep_sweep_cuda(*args, COLSWEEP_WIDE, shapes)
    assert _nvcc.launches == {
        "colsweep.sweep.regs" if k_rows else "colsweep.sweep.smem": 1}
    assert torch.equal(ring, colsweep.colsweep_sweep_torch(
        *args, COLSWEEP_WIDE, shapes))
    rows = colsweep.colsweep_chain_cuda(args[0], ring, COLSWEEP_WIDE)
    assert torch.equal(rows, colsweep.colsweep_chain_torch(
        args[0], ring, COLSWEEP_WIDE))
    out = rows.cpu().numpy()
    for p in (0, 5):
        qc, tc, ql, rl = pairs[p]
        assert tuple(out[p, :3]) == tuple(align_one_sweep(qc, tc, ql, rl,
                                                          COLSWEEP_WIDE)), p


def test_colsweep_sweep_refuses_shapes_it_cannot_hold(cuda):
    """Shapes past the wire or past shared memory raise ValueError
    before any launch, and the context stays usable."""
    pairs = _pairs(19, 8, 100, 200)
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, CANON)
    R, Q, d_pad = colsweep.colsweep_shapes(meta, tcodes, qfwd, CANON)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    _nvcc.launches.clear()
    for bad in ((2 * tcodes.shape[1] + 32, Q, d_pad), (R, Q, R + Q - 2),
                (R, Q, colsweep.SMEM_LIMIT // 4)):
        with pytest.raises(ValueError):
            colsweep.colsweep_sweep_cuda(*args, CANON, bad)
    assert not _nvcc.launches
    assert torch.equal(colsweep.align_bucket_colsweep(*args, CANON),
                       kernel.align_bucket(*args, CANON))


def test_engine_colsweep_on_cuda_matches_cpu(cuda):
    enc = make_workload(600, 150, seed=3, spread=0.05)
    _nvcc.launches.clear()
    res = AlignEngine(CANON, device=cuda).align(enc, per_bucket_times=True)
    assert res.routes == ["colsweep"] * res.n_buckets
    assert (_nvcc.launches["antidiag.score"],
            _nvcc.launched("colsweep.sweep"),
            _nvcc.launches["colsweep.chain"]) == (0, res.n_buckets,
                                                  res.n_buckets)
    assert len(res.bucket_ms) == res.n_buckets
    ref = AlignEngine(CANON, device="cpu").align(enc)
    assert ref.routes == res.routes
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert (getattr(res, f) == getattr(ref, f)).all(), f


def _leading_gaps():
    """Two pairs whose paths start with a gap (the diagonal -1 step)."""
    s = "ACGTTGCAACGATCCTAGGATTACAGGCATCGATCGGATCCATGCAAGT" * 4
    return [(encode_padded("T" * 10 + s), encode_padded(s),
             len(s) + 10, len(s)),
            (encode_padded(s), encode_padded("G" * 10 + s),
             len(s), len(s) + 10)]


# the traceback buckets: full width (z 400, strips at z -1), windowed
# (bw 60), asymmetric (bw 50), all-N and 1x1 padding rows
TB_CASES = {
    "full-z400": (CANON, lambda: _pairs(21, 8, 250, 500) + _leading_gaps()),
    "full-z-1-strips": (AlignConfig(match=2, mismatch=3, gap_open=5,
                                    gap_extend=1, slice_width=2,
                                    z_threshold=-1, band_width=751),
                        lambda: _pairs(22, 8, 250, 500)),
    "windowed-bw60": (CFGS[3], lambda: _pairs(23, 8, 600, 900)),
    "asymmetric-bw50": (AlignConfig(match=1, mismatch=4, gap_open=6,
                                    gap_extend=2, band_width=50,
                                    z_threshold=-1),
                        lambda: [(p[0], q[1], p[2], q[3]) for p, q in zip(
                            _pairs(24, 4, 1, 120), _pairs(25, 4, 600, 700))]
                        + [(q[0], p[1], q[2], p[3]) for p, q in zip(
                            _pairs(26, 4, 1, 120), _pairs(27, 4, 600, 700))]),
    "all-N-and-padding": (CANON, lambda: [
        (np.full(48, 14, np.uint8), _pairs(28, 1, 60, 61)[0][1], 48, 60),
        (_pairs(29, 1, 70, 71)[0][0], np.full(40, 14, np.uint8), 70, 40),
        (np.full(40, 14, np.uint8), np.full(40, 14, np.uint8), 33, 33),
        (encode_padded("A"), encode_padded("A"), 1, 1),
    ] + _pairs(30, 3, 1, 300)),
}


def _tb_bucket(cuda, case):
    cfg, make = TB_CASES[case]
    meta, tcodes, qfwd = kernel.build_bucket_arrays(make(), cfg)
    planes = kernel.flag_planes_needed(meta, cfg)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    vbases = torch.from_numpy(
        walk.vbase_schedule(planes, cfg, 2 * tcodes.shape[1])).to(cuda)
    return cfg, planes, args, vbases


def _swept_planes_equal(a, b, out, planes, mask):
    """Bitmaps equal on every computed cell (``mask``: the plain
    version's `return_mask`) of every plane before each pair's last
    swept one: the walk reads no other nibble (tests/test_torch_tiles.py
    holds it to that), and the kernel leaves the others unwritten."""
    gb = a.shape[0]
    last = ((out[:, 3] - 1) >> 3).clamp(min=0)
    keep = torch.arange(planes, device=a.device)[None, :] < last[:, None]
    return torch.equal((a & mask).view(gb, planes, -1)[keep],
                       (b & mask).view(gb, planes, -1)[keep])


@pytest.mark.parametrize("case", list(TB_CASES))
def test_flags_kernel_equals_plain(cuda, case):
    """B3: the flag-emitting kernel's results, swept planes and walked
    words equal the plain version's."""
    cfg, planes, args, vbases = _tb_bucket(cuda, case)
    _nvcc.launches.clear()
    out, flags = kernel.align_bucket(*args, cfg, emit_flags=True,
                                     planes=planes)
    assert _nvcc.launches == {"antidiag.flags": 1}
    ref, ref_flags, mask = kernel.align_bucket_torch(
        *args, cfg, emit_flags=True, planes=planes, return_mask=True)
    assert torch.equal(out, ref)
    assert torch.equal(out, kernel.align_bucket(*args, cfg))
    assert _swept_planes_equal(flags, ref_flags, out, planes, mask)
    assert torch.equal(walk.walk_torch(flags, vbases, out),
                       walk.walk_torch(ref_flags, vbases, ref))


@pytest.mark.parametrize("case", list(TB_CASES))
def test_walk_kernel_equals_walk_torch(cuda, case):
    """B6 on the kernel's flags equals walk_torch on the same flags."""
    cfg, planes, args, vbases = _tb_bucket(cuda, case)
    out, flags = kernel.align_bucket(*args, cfg, emit_flags=True,
                                     planes=planes)
    _nvcc.launches.clear()
    words = walk.walk(flags, vbases, out)
    assert _nvcc.launches == {"walk": 1}
    assert words.shape == (out.shape[0], walk.words_per_pair(planes))
    assert torch.equal(words, walk.walk_torch(flags, vbases, out))


@pytest.mark.parametrize("mode", ["device", "host"])
def test_engine_traceback_on_cuda_matches_cpu(cuda, monkeypatch, mode):
    """align(traceback=True) on the card equals the CPU engine, one B3
    and one B6 launch per bucket in device mode and no plain version
    called; every CIGAR rescores to its score."""
    enc = _pairs(31, 40, 50, 1500) + _leading_gaps()
    ecfg = EngineConfig(aligns_per_batch=16, traceback_mode=mode)
    ref = AlignEngine(CANON, ecfg, device="cpu").align(enc, traceback=True)

    def boom(*_a, **_k):
        raise AssertionError("plain version called on the card")

    monkeypatch.setattr(kernel, "align_bucket_torch", boom)
    monkeypatch.setattr(walk, "walk_torch", boom)
    _nvcc.launches.clear()
    res = AlignEngine(CANON, ecfg, device=cuda).align(
        enc, traceback=True, per_bucket_times=True)
    n = res.n_buckets
    if mode == "device":
        assert res.routes == ["walk"] * n
        assert (_nvcc.launches["antidiag.score"],
                _nvcc.launches["antidiag.flags"],
                _nvcc.launches["walk"]) == (0, n, n)
    assert res.routes == ref.routes and len(res.bucket_ms) == n
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert (getattr(res, f) == getattr(ref, f)).all(), f
    assert res.cigars == ref.cigars
    for i, (qc, tc, _ql, _rl) in enumerate(enc):
        if res.cigars[i]:
            assert score_cigar(res.cigars[i], qc, tc, CANON) == res.scores[i]
            assert cigar_to_pairs(res.cigars[i]) == (
                res.query_ends[i] + 1, res.target_ends[i] + 1)



def _unrelated(seed, shapes):
    out = []
    for i, (ql, rl) in enumerate(shapes):
        q = _pairs(seed + i, 1, ql, ql + 1)[0]
        t = _pairs(seed + 100 + i, 1, rl, rl + 1)[0]
        out.append((q[0], t[0], ql, rl))
    return out


# the banded column-sweep buckets: bw 63 mixed, bw 31 with tight z and
# shapes that reach the empty-slice cap, bw 751 where the window rolls,
# a second scoring config, all-N and 1x1 padding rows
COLBAND_CASES = {
    "bw63-mixed": (AlignConfig(match=1, mismatch=4, gap_open=6,
                               gap_extend=2, slice_width=3, z_threshold=400,
                               band_width=63),
                   lambda: _pairs(41, 24, 8, 300)),
    "bw31-z20-empty-slices": (
        AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=20, band_width=31),
        lambda: _unrelated(42, [(16, 600), (600, 16), (200, 200), (64, 257),
                                (1, 100), (100, 1), (300, 33), (33, 300)])),
    "bw751-rolling": (CANON, lambda: _pairs(43, 16, 400, 3000)),
    "m2x3-s5-bw55": (AlignConfig(match=2, mismatch=3, gap_open=5,
                                 gap_extend=1, slice_width=5,
                                 z_threshold=150, band_width=55),
                     lambda: _pairs(44, 16, 8, 500)),
    "all-N-and-padding": (COLSWEEP_CFGS[0], lambda: [
        (np.full(48, 14, np.uint8), _pairs(45, 1, 60, 61)[0][1], 48, 60),
        (_pairs(46, 1, 70, 71)[0][0], np.full(40, 14, np.uint8), 70, 40),
        (np.full(40, 14, np.uint8), np.full(40, 14, np.uint8), 33, 33),
        (encode_padded("A"), encode_padded("A"), 1, 1),
    ] + _pairs(47, 3, 1, 300)),
}


@pytest.mark.parametrize("case", list(COLBAND_CASES))
def test_colband_kernel_equals_plain_antidiag_and_oracle(cuda, case):
    """B7 == colband_torch == the antidiagonal kernel (all four columns)
    == the oracle, one launch, no synchronising input needed."""
    cfg, make = COLBAND_CASES[case]
    pairs = make()
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    shapes = colband.colband_shapes(meta, cfg)
    scalars = torch.from_numpy(colband.chain_scalars(meta, cfg)).to(cuda)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    _nvcc.launches.clear()
    got = colband.align_bucket_colband(*args, cfg, shapes=shapes,
                                       scalars=scalars)
    assert _nvcc.launched("colband") == 1
    assert torch.equal(got, colband.colband_torch(scalars, args[1], args[2],
                                                  cfg, shapes))
    assert torch.equal(got, kernel.align_bucket(*args, cfg))
    assert torch.equal(got, colband.align_bucket_colband(*args, cfg))
    out = got.cpu().numpy()
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        assert tuple(out[p, :3]) == tuple(align_one_sweep(qc, tc, ql, rl,
                                                          cfg)), p


@pytest.mark.parametrize("rows", colband.COLBAND_ROWS)
@pytest.mark.parametrize("case", ["bw751-rolling", "bw31-z20-empty-slices",
                                  "all-N-and-padding"])
def test_colband_instance_equals_plain_and_oracle(cuda, case, rows):
    """Each B7 instance (R rows a thread) == the plain version == the
    oracle, its own launch counter and the total one up by one."""
    cfg, make = COLBAND_CASES[case]
    pairs = make()
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    shapes = colband.colband_shapes(meta, cfg)
    scalars = torch.from_numpy(colband.chain_scalars(meta, cfg)).to(cuda)
    tc, qf = (torch.from_numpy(a).to(cuda) for a in (tcodes, qfwd))
    _nvcc.launches.clear()
    got = colband.colband_cuda(scalars, tc, qf, cfg, shapes, rows=rows)
    assert _nvcc.launches == {f"colband.r{rows}": 1}
    assert torch.equal(got, colband.colband_torch(scalars, tc, qf, cfg,
                                                  shapes))
    out = got.cpu().numpy()
    for p, (qc, tc_, ql, rl) in enumerate(pairs):
        assert tuple(out[p, :3]) == tuple(align_one_sweep(qc, tc_, ql, rl,
                                                          cfg)), p


def test_colband_kernel_any_gb(cuda):
    """GB neither a multiple of 8 nor of 128."""
    cfg = COLBAND_CASES["bw63-mixed"][0]
    meta, tcodes, qfwd = kernel.build_bucket_arrays(_pairs(48, 40, 8, 300),
                                                    cfg)
    n = 37
    args = tuple(torch.from_numpy(a[:n].copy()).to(cuda)
                 for a in (meta, tcodes, qfwd))
    got = colband.align_bucket_colband(*args, cfg)
    full = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    assert got.shape == (n, 4)
    assert torch.equal(got, kernel.align_bucket(*full, cfg)[:n])


def test_colband_wide_window(cuda):
    """bw 2001 (the ONT band): RW 4048, 506 row threads."""
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      band_width=2001, z_threshold=400)
    pairs = _pairs(5, 4, 4200, 5000)
    meta, tcodes, qfwd = kernel.build_bucket_arrays(pairs, cfg)
    assert colband.colband_shapes(meta, cfg)[0] == 4048
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    got = colband.align_bucket_colband(*args, cfg)
    assert torch.equal(got, kernel.align_bucket(*args, cfg))


def test_colband_refuses_bad_inputs_before_launch(cuda):
    cfg = COLBAND_CASES["bw63-mixed"][0]
    meta, tcodes, qfwd = kernel.build_bucket_arrays(_pairs(49, 8, 8, 200),
                                                    cfg)
    args = tuple(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd))
    shapes = colband.colband_shapes(meta, cfg)
    scalars = torch.from_numpy(colband.chain_scalars(meta, cfg))
    _nvcc.launches.clear()
    with pytest.raises(ValueError):   # scalars left on the CPU
        colband.align_bucket_colband(*args, cfg, shapes=shapes,
                                     scalars=scalars)
    with pytest.raises(ValueError):
        colband.align_bucket_colband(*args, cfg, shapes=(8192,) + shapes[1:],
                                     scalars=scalars.to(cuda))
    with pytest.raises(ValueError):
        colband.align_bucket_colband(args[0], args[1].t().contiguous().t(),
                                     args[2], cfg)
    assert not _nvcc.launches


def test_engine_colband_on_cuda_matches_cpu(cuda, monkeypatch):
    """EngineConfig(colband=True) on the card: every bucket routed to
    B7, one launch each, no plain version called, results equal to the
    CPU engine and to the antidiagonal route."""
    cfg = COLBAND_CASES["bw63-mixed"][0]
    enc = _pairs(51, 300, 100, 700)
    ecfg = EngineConfig(colband=True)
    ref = AlignEngine(cfg, ecfg, device="cpu").align(enc)

    def boom(*_a, **_k):
        raise AssertionError("plain version called on the card")

    monkeypatch.setattr(colband, "colband_torch", boom)
    _nvcc.launches.clear()
    res = AlignEngine(cfg, ecfg, device=cuda).align(enc,
                                                    per_bucket_times=True)
    n = res.n_buckets
    assert res.routes == ref.routes == ["colband"] * n
    assert (_nvcc.launches["antidiag.score"],
            _nvcc.launched("colband")) == (0, n)
    assert len(res.bucket_ms) == n
    anti = AlignEngine(cfg, EngineConfig(colsweep=False),
                       device=cuda).align(enc)
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert (getattr(res, f) == getattr(ref, f)).all(), f
        assert (getattr(res, f) == getattr(anti, f)).all(), f


PROBE_VARIANTS = {
    "full": {}, "no-chain": {"with_chain": False},
    "no-prefix": {"n_prefix": 1}, "no-ring": {"with_ring": False},
    "bare": {"n_prefix": 1, "with_ring": False, "with_chain": False},
    "window-8": {"n_prefix": 3},
}


@pytest.mark.parametrize("variant", list(PROBE_VARIANTS))
@pytest.mark.parametrize("RW", [384, 160])
@pytest.mark.parametrize("rows", colband.COLBAND_ROWS)
def test_probe_instances_equal_plain(cuda, variant, RW, rows):
    """P2: each probe instance (R rows a thread, each switch set) equals
    colband_probe_torch, the four outputs and the final H, F and ring,
    with ragged column counts."""
    switches = PROBE_VARIANTS[variant]
    ncols = 256
    meta, prev = colband_probe.probe_inputs(1, ncols, cuda)
    meta[0, 1::3] = ncols - 13
    meta[0, 2::3] = 40
    prev = prev + torch.arange(4, dtype=torch.int32, device=cuda)[:, None]
    _nvcc.launches.clear()
    out, state = colband_probe.colband_probe_cuda(
        meta, prev, RW, ncols, return_state=True, rows=rows, **switches)
    assert _nvcc.launches == {f"probe.colband.r{rows}": 1}
    ref, ref_state = colband_probe.colband_probe_torch(
        meta, prev, RW, ncols, return_state=True, **switches)
    assert torch.equal(out, ref)
    assert torch.equal(state, ref_state)
    assert torch.equal(out, colband_probe.colband_probe(meta, prev, RW,
                                                        ncols, **switches))


def test_bench_harness_times_the_production_kernel(cuda):
    cfg = COLBAND_CASES["bw63-mixed"][0]
    meta, tcodes, qfwd = kernel.build_bucket_arrays(_pairs(52, 64, 100, 300),
                                                    cfg)
    _nvcc.launches.clear()
    r = colband_bench.bench_bucket(meta, tcodes, qfwd, cfg, reps=4, rounds=2)
    assert _nvcc.launched("colband") == 1 + 2 * (4 + 2)
    assert r["ms"] > 0 and r["ns_per_col"] > 0
    assert r["cols"] == int(meta[:, 0].max())


@pytest.mark.parametrize("rows", colband.COLBAND_ROWS)
def test_colband_split_instance_equals_production(cuda, rows):
    """Each R's clock64 instance gives the production instance's outputs
    (`column_split` raises otherwise), one part row per row warp."""
    cfg = COLBAND_CASES["bw751-rolling"][0]
    meta, tcodes, qfwd = kernel.build_bucket_arrays(_pairs(53, 8, 1500,
                                                           2500), cfg)
    RW = colband.colband_shapes(meta, cfg)[0]
    r = colband_bench.column_split(meta, tcodes, qfwd, cfg, rows)
    assert r["rows"] == rows and 0 < r["columns"] <= int(meta[:, 0].max())
    assert len(r["cycles_per_column"]["row warps"]) == \
        colband.block_threads(RW, rows) // 32 - 1


def _ragged_meta(seed, n, lo, hi, device):
    """(n, 2) int32 [qlen, rlen], each drawn in [lo, hi) per pair."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, (n, 2)).astype(
        np.int32)).to(device)


@pytest.mark.parametrize("n_waves", [1, 2, 4])
@pytest.mark.parametrize("W, n_diags", [(256, 20), (64, 3), (256, 0)])
def test_wave_probe_instances_equal_plain(cuda, n_waves, W, n_diags):
    """P3: each instance equals wave_probe_torch, the four outputs and
    the whole final state, with ragged meta; 20 packed diagonals pass the
    feed phase's wrap, 0 returns the initial state."""
    meta = _ragged_meta(60 + n_waves, 24, 90, 462, cuda)
    _nvcc.launches.clear()
    out, state = wave_probe.wave_probe_cuda(meta, W, n_waves, n_diags,
                                            return_state=True)
    assert _nvcc.launches == {"probe.wave": 1}
    ref, ref_state = wave_probe.wave_probe_torch(meta, W, n_waves, n_diags,
                                                 return_state=True)
    assert torch.equal(out, ref)
    assert torch.equal(state, ref_state)
    assert torch.equal(out, wave_probe.wave_probe(meta, W, n_waves, n_diags))


@pytest.mark.parametrize("frame", ["current", "skewed"])
@pytest.mark.parametrize("masks", ["cell", "interval"])
def test_skew_probe_instances_equal_plain(cuda, frame, masks):
    """P4: each instance at its full width (1024 / 896 threads) equals
    skew_probe_torch, outputs and final state, with ragged meta."""
    W = 1024 if frame == "current" else 896
    meta = _ragged_meta(70, 16, 200, 1400, cuda)
    _nvcc.launches.clear()
    out, state = skew_probe.skew_probe_cuda(meta, W, 20, frame=frame,
                                            masks=masks, return_state=True)
    assert _nvcc.launches == {"probe.skew": 1}
    ref, ref_state = skew_probe.skew_probe_torch(
        meta, W, 20, frame=frame, masks=masks, return_state=True)
    assert torch.equal(out, ref)
    assert torch.equal(state, ref_state)


def test_substep_probes_refuse_bad_inputs(cuda):
    meta = _ragged_meta(80, 8, 90, 462, cuda)
    _nvcc.launches.clear()
    with pytest.raises(ValueError, match="CUDA tensors"):
        wave_probe.wave_probe_cuda(meta.cpu(), 256, 1, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        skew_probe.skew_probe_cuda(meta.cpu(), 1024, 4)
    with pytest.raises(ValueError, match="int32"):
        wave_probe.wave_probe_cuda(meta.long(), 256, 1, 4)
    with pytest.raises(ValueError, match="int32"):
        skew_probe.skew_probe_cuda(meta.long(), 1024, 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        wave_probe.wave_probe_cuda(meta, 100, 1, 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        wave_probe.wave_probe_cuda(meta, 512, 4, 4)
    with pytest.raises(ValueError, match="n_waves"):
        wave_probe.wave_probe_cuda(meta, 256, 3, 4)
    with pytest.raises(ValueError, match="frame"):
        skew_probe.skew_probe_cuda(meta, 1024, 4, frame="diagonal")
    assert not _nvcc.launches


# --- the command line and streaming on the card --------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CANON_FLAGS = ["-m", "1", "-x", "4", "-q", "6", "-r", "2"]


def _cli(*args):
    """The port's command line as a subprocess from the repo root, on
    the card (no --device: cuda is the default)."""
    proc = subprocess.run(
        [sys.executable, "-m", "agatha_tpu_torch.cli", *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


@pytest.mark.parametrize("case, flags, files", [
    ("score", [], ("query.fasta", "target.fasta")),
    ("score2", ["-w", "15", "-z", "-1"], ("query2.fasta", "target2.fasta")),
])
def test_cli_golden_on_cuda(cuda, case, flags, files):
    proc = _cli("-p", *CANON_FLAGS, *flags,
                *(os.path.join(GOLDEN, f) for f in files))
    with open(os.path.join(GOLDEN, f"{case}.log")) as f:
        assert proc.stdout == f.read()


def _mixed_route_fasta(tmp_path):
    """300 short reads (the column sweep) then 40 pairs past the window
    (the windowed antidiagonal kernel), with op codes."""
    rng = np.random.default_rng(17)
    bases = np.array(list("ACGT"))
    qs, ts = [], []
    for i in range(340):
        n = int(rng.integers(100, 150) if i < 300
                else rng.integers(1200, 2200))
        q = bases[rng.integers(0, 4, n)]
        t = q.copy()
        sub = rng.random(n) < 0.08
        t[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
        qs.append("".join(q))
        ts.append("".join(t[: n - int(rng.integers(0, 20))]))
    qf, tf = tmp_path / "q.fasta", tmp_path / "t.fasta"
    write_fasta(str(qf), qs, ops=list(np.arange(340) % 4))
    write_fasta(str(tf), ts)
    return qf, tf


@pytest.mark.parametrize("cigar", [[], ["--cigar"]])
def test_cli_stream_equals_batch_on_mixed_routes(cuda, tmp_path, cigar):
    qf, tf = _mixed_route_fasta(tmp_path)
    batch = _cli("-p", *cigar, *CANON_FLAGS, qf, tf)
    stream = _cli("-p", "--stream", "-a", "256", *cigar, *CANON_FLAGS, qf, tf)
    assert stream.stdout == batch.stdout
    assert len(batch.stdout.splitlines()) == 340
    assert "chunks=2 " in stream.stderr


def test_align_stream_on_cuda_equals_align(cuda):
    enc = _pairs(23, 300, 20, 160) + _pairs(29, 40, 1100, 2000)
    eng = AlignEngine(CANON, EngineConfig(aligns_per_batch=128), device=cuda)
    batch = eng.align(enc)
    for tb in (False, True):
        chunks = list(eng.align_stream(iter(enc), traceback=tb))
        assert [len(c.scores) for c in chunks] == [128, 128, 84]
        assert chunks[0].routes == (["walk"] * chunks[0].n_buckets if tb
                                    else ["colsweep"] * chunks[0].n_buckets)
        for f in ("scores", "query_ends", "target_ends", "diags"):
            got = np.concatenate([getattr(c, f) for c in chunks])
            assert (got == getattr(batch, f)).all(), f
        if tb:
            cigars = sum((c.cigars for c in chunks), [])
            assert cigars == eng.align(enc, traceback=True).cigars
            for i, (qc, tc, _ql, _rl) in enumerate(enc):
                if cigars[i]:
                    assert cigar_to_pairs(cigars[i]) == (
                        batch.query_ends[i] + 1, batch.target_ends[i] + 1)
                    assert score_cigar(cigars[i], qc, tc, CANON) == (
                        batch.scores[i])


def test_host_to_device_stages_every_array_exactly(cuda):
    """Pinned staging on the calling thread: dtypes, strided and empty
    inputs, and 200 stagings queued without a synchronisation, whose
    pinned buffers the host allocator reuses only once their copies are
    done."""
    rng = np.random.default_rng(23)
    meta = rng.integers(0, 2**31 - 1, (513, 2)).astype(np.int32)
    codes = rng.integers(0, 256, (512, 96)).astype(np.uint8)
    arrays = (meta, codes, meta[::3], codes.T, codes[:0])
    out = sharding.host_to_device(arrays, cuda)
    for a, t in zip(arrays, out):
        assert t.device.type == "cuda" and t.is_contiguous()
        np.testing.assert_array_equal(t.cpu().numpy(), a)
    rounds = [rng.integers(0, 256, (512, 96)).astype(np.uint8)
              for _ in range(200)]
    staged = [sharding.host_to_device((a,), cuda)[0] for a in rounds]
    torch.cuda.synchronize()
    for a, t in zip(rounds, staged):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_sharded_on_two_slots_equals_one_device(cuda):
    """align_bucket_sharded over two slots of one card: two launches,
    one a shard, whose rows equal align_bucket on one device."""
    for cfg, lo, hi in ((CANON, 50, 400), (CFGS[3], 900, 1500)):
        meta, tcodes, qfwd = kernel.build_bucket_arrays(
            _pairs(31, 16, lo, hi), cfg)
        mesh = sharding.make_pairs_mesh(["cuda:0", "cuda:0"])
        _nvcc.launches.clear()
        shards = sharding.align_bucket_sharded(meta, tcodes, qfwd, cfg, mesh)
        assert _nvcc.launches == {"antidiag.score": 2}
        assert [s.shape[0] for s in shards] == [meta.shape[0] // 2] * 2
        assert all(s.device == mesh[0] for s in shards)
        one = kernel.align_bucket(
            *(torch.from_numpy(a).to(cuda) for a in (meta, tcodes, qfwd)),
            cfg)
        assert torch.equal(torch.cat(shards), one)


@pytest.mark.parametrize("slots", [("cuda:0", "cuda:0"), ("cuda:0", "cpu")])
@pytest.mark.parametrize("traceback", [False, True])
def test_engine_on_two_slots_equals_one(cuda, monkeypatch, traceback, slots):
    """The engine pinned to two slots: antidiagonal buckets sharded,
    colsweep buckets and traceback parts in turn; the four fields,
    CIGARs and per-bucket times as on one slot.  With a card and the
    CPU as the slots, the score path's outputs lie on two devices, so
    the gather takes its path for several devices (pinned copies
    without blocking, one wait a device) and a bucket's time is the
    card's events or the host clock."""
    import agatha_tpu_torch.engine as engine_mod

    gathered = []
    real_gather = engine_mod._gather_rows

    def spy_gather(parts):
        gathered.append({p.device for p in parts})
        return real_gather(parts)

    monkeypatch.setattr(engine_mod, "_gather_rows", spy_gather)
    enc = _pairs(37, 200, 20, 160) + _pairs(41, 40, 1100, 2000)
    ecfg = EngineConfig(aligns_per_batch=128)
    one = AlignEngine(CANON, ecfg, device=cuda).align(
        enc, traceback=traceback, per_bucket_times=True)
    gathered.clear()
    eng = AlignEngine(CANON, ecfg, device=cuda)
    eng._devices = sharding.make_pairs_mesh(slots)
    two = eng.align(enc, traceback=traceback, per_bucket_times=True)
    if traceback:
        assert two.routes == ["walk"] * two.n_buckets
        assert two.n_buckets > one.n_buckets
        assert gathered == []
    else:
        assert two.routes == [{"anti": "anti-sharded"}.get(r, r)
                              for r in one.routes]
        assert "anti-sharded" in two.routes and "colsweep" in two.routes
        assert gathered == [set(eng._slots())]
    assert len(two.bucket_ms) == two.n_buckets
    assert all(m > 0 for m in two.bucket_ms)
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert (getattr(two, f) == getattr(one, f)).all(), f
    assert two.cigars == one.cigars


@pytest.mark.parametrize("slots", [("cuda:0",), ("cuda:0", "cuda:0")])
def test_engine_decodes_beside_the_card(cuda, slots):
    """Device traceback in many sub-buckets (1 MiB of flags a bucket):
    the decode worker starts on the first buckets' CIGARs while the card
    still runs the later ones (`decode.beside_card` > 0 with the trace
    on), on one slot and on two slots of one card; the results equal the
    CPU engine's."""
    from agatha_tpu_torch import trace

    enc = _pairs(43, 64, 1000, 1600)
    ecfg = EngineConfig(aligns_per_batch=32, tb_flag_bytes=1 << 20)
    ref = AlignEngine(CANON, ecfg, device="cpu").align(enc, traceback=True)
    eng = AlignEngine(CANON, ecfg, device=cuda)
    eng._devices = sharding.make_pairs_mesh(slots)
    eng.align(enc, traceback=True)  # builds the kernels
    trace.drain()
    trace.enable()
    try:
        res = eng.align(enc, traceback=True)
    finally:
        trace.disable()
    _spans, counts = trace.drain()
    total = {k: sum(v for (_c, name), v in counts.items() if name == k)
             for k in ("decode.buckets", "decode.beside_card")}
    assert res.routes == ["walk"] * res.n_buckets and res.n_buckets >= 8
    assert total["decode.buckets"] == res.n_buckets
    assert total["decode.beside_card"] > 0
    for f in ("scores", "query_ends", "target_ends", "diags"):
        assert (getattr(res, f) == getattr(ref, f)).all(), f
    assert res.cigars == ref.cigars and any(res.cigars)
