"""csrc/colband.cu's banded column sweep (B7) itself, compiled with g++
against the stand-in for the CUDA built-ins of
tests/test_torch_antidiag_standin.py, against `colband_torch` and the
oracle on the CPU, each instance (R = 2, 4, 8 rows a thread) on every
case.

The kernel's source is used as it is up to its launch helper (the
parameter set-up `colband_params` included); the lines declaring the
dynamic shared memory are rewritten to a buffer of the launch, filled
with garbage before every block.  One fiber per CUDA thread runs the
warps' shuffle scans, the two block barriers of a column and the chain
warp; it checks the arithmetic, the scan across warps, the window roll
across warp boundaries (8 / R threads hand their rows on), the chain
warp's frontier and rounds and the early exit, not the card's
compiler, timing or memory model.
Buckets: the colband cases of tests/test_torch_colband.py, windows of
two to 24 row warps that roll, paths along the warps' boundaries (at 8
rows a thread and at the instance's own) and vertical gaps longer than
a warp, a Z-drop inside a group, and 20 seeded random buckets; the
clock64 instances on one bucket; and the chain warp's rounds alone on
synthetic per-diagonal maxima (Z-drops and the end cap inside a round,
ties).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from agatha_tpu.config import AlignConfig as JaxAlignConfig
from agatha_tpu.ops.sweep import align_one_sweep
from agatha_tpu_torch.config import AlignConfig, config_from
from agatha_tpu_torch.ops import colband as cb
from agatha_tpu_torch.ops import colsweep as cs
from agatha_tpu_torch.ops import kernel as tk
from agatha_tpu_torch.ops.packing import encode_padded
from agatha_tpu_torch.probes import colband_probe

from .conftest import mutate, random_seq
from .test_torch_antidiag_standin import CSRC, compile_standin
from .test_torch_colband import (
    BW63,
    EMPTY_SLICE_SHAPES,
    JAX_CONFIGS,
    _pairs,
    _unrelated,
)

torch.set_num_threads(1)

DRIVER = r"""
#include <algorithm>
#include "cuda_runtime.h"
static int* g_dyn;
#include "kernel_body.inc"
template <int R>
void run_blocks(const Params& p, long long* split) {
  std::vector<int> dyn(colband_smem_ints(p));
  g_dyn = dyn.data();
  for (int b = 0; b < p.gb; ++b) {
    std::fill(dyn.begin(), dyn.end(), 0x5A5A5A5A);
    run_block(b, p.nbpad + 32, [&] {
      if (split != nullptr)
        colband_kernel<R, true>(p, split);
      else
        colband_kernel<R, false>(p, nullptr);
    });
  }
}
extern "C" int run(const void* scal, const void* tcodes, const void* qfwd,
                   void* out, int gb, int wt, int qf, int RW, int Qpad,
                   int LEAD, int WMAX, int match, int mismatch, int goe,
                   int ge, int sw, int z, int bw, int rows, void* split) {
  Params p;
  if (!colband_params(p, scal, tcodes, qfwd, out, gb, wt, qf, RW, Qpad,
                      LEAD, WMAX, match, mismatch, goe, ge, sw, z, bw, rows))
    return 1;
  auto* sp = static_cast<long long*>(split);
  switch (rows) {
    case 2: run_blocks<2>(p, sp); break;
    case 4: run_blocks<4>(p, sp); break;
    default: run_blocks<8>(p, sp); break;
  }
  return 0;
}
// The probe instance the launcher picks for these switches, one block
// per pair; 1 if the shapes are out of its range.
extern "C" int probe(const void* meta, const void* prev, void* out,
                     void* state, int n, int RW, int ncols, int with_chain,
                     int n_prefix, int with_ring, int rows) {
  ProbeParams p;
  if (!probe_params(p, meta, prev, out, state, n, RW, ncols, n_prefix,
                    rows))
    return 1;
  const ProbeKernel kernel =
      probe_instance(rows, with_chain != 0, with_ring != 0, n_prefix < 0);
  std::vector<int> dyn(probe_smem_ints(p));
  g_dyn = dyn.data();
  for (int b = 0; b < n; ++b) {
    std::fill(dyn.begin(), dyn.end(), 0x5A5A5A5A);
    run_block(b, p.nbpad + 32, [&] { kernel(p); });
  }
  return 0;
}
// The probe's segment chain (probe_segment) by one warp over n_seg
// segments of 16 ring entries, as probe_kernel's chain warp takes them
// (segment s at diagonal 16 s - 8); carry holds (ms, mr, mq, term, diags)
// after each.
extern "C" void probe_chain(const int* seg, int n_seg, int* carry) {
  run_block(0, 32, [&] {
    const int lane = threadIdx.x & 31;
    ProbeCarry c = {0, 0, 0, 0, 0};
    for (int s = 0; s < n_seg; ++s) {
      probe_segment(c, lane < 16 ? seg[16 * s + lane] : INT_MIN,
                    16 * s - 8);
      if (lane == 0) {
        int* const o = carry + 5 * s;
        o[0] = c.ms; o[1] = c.mr; o[2] = c.mq; o[3] = c.term;
        o[4] = c.diags;
      }
    }
  });
}
// One warp's chain_round over `diag` (the per-diagonal maxima of
// diagonals 0 .. n - 1) in a ring of rs entries, in rounds of at most
// `step` diagonals; out is [score, query_end, target_end, diagonals].
extern "C" void chain(const int* diag, int n, int rs, int i_end8,
                      int n_diags, int end_p, int z, int ge, int step,
                      int* out) {
  std::vector<int> ring(ring_ints(rs), INT_MIN);
  for (int d = 0; d < n; ++d) ring[ring_slot(d, rs)] = diag[d];
  run_block(0, 32, [&] {
    Chain c = {0, 0, 0, 0, 0, false};
    while (!c.term && c.next < end_p)
      chain_round(c, ring.data(), rs, std::min(c.next + step, end_p),
                  i_end8, n_diags, z, ge);
    if (threadIdx.x == 0) {
      out[0] = c.ms; out[1] = c.mq; out[2] = c.mr; out[3] = c.diags;
    }
  });
}
"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    d = tmp_path_factory.mktemp("colband_standin")
    with open(os.path.join(CSRC, "colband.cu")) as f:
        src = f.read()
    body = src[:src.index(
        "template <int R>\ncudaError_t launch_instance(")]
    body, n = re.subn(r"extern __shared__ int smem\[\];",
                      "int* const smem = g_dyn;", body)
    assert n == 2  # the sweep and the probe
    lib = compile_standin(d, body + "}  // namespace\n", DRIVER)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [vp] * 4 + [ci] * 15 + [vp]
    lib.run.restype = ci
    lib.chain.argtypes = [vp] + [ci] * 8 + [vp]
    lib.chain.restype = None
    lib.probe.argtypes = [vp] * 4 + [ci] * 7
    lib.probe.restype = ci
    lib.probe_chain.argtypes = [vp, ci, vp]
    lib.probe_chain.restype = None
    return lib


@pytest.fixture(params=cb.COLBAND_ROWS, ids=[f"r{r}" for r in
                                             cb.COLBAND_ROWS])
def rows(request):
    """Rows a thread R of the instance under test."""
    return request.param


def run_colband(lib, meta, tcodes, qfwd, cfg, rows, split=False):
    """The output (GB, 4) of the instance of `rows` rows a thread on the
    CPU (its clock64 instance with `split`)."""
    shapes = cb.colband_shapes(meta, cfg)
    RW, _r8, Qpad, _g, _ga, _gb, _t, LEAD, WMAX = shapes
    scal = np.ascontiguousarray(cb.chain_scalars(meta, cfg))
    tcodes = np.ascontiguousarray(tcodes)
    qfwd = np.ascontiguousarray(qfwd)
    gb = meta.shape[0]
    out = np.full((gb, 4), -7, np.int32)
    sp = np.zeros((gb, cb.block_threads(RW, rows) // 32, 8), np.int64)
    assert lib.run(scal.ctypes.data, tcodes.ctypes.data, qfwd.ctypes.data,
                   out.ctypes.data, gb, 2 * tcodes.shape[1],
                   2 * qfwd.shape[1], RW, Qpad, LEAD, WMAX, cfg.match,
                   cfg.mismatch, cfg.gap_oe, cfg.gap_extend,
                   cfg.slice_width, cfg.z_threshold, cfg.band_width,
                   rows, sp.ctypes.data if split else None) == 0
    return out, shapes


def test_colband_standin_launch_bound_matches_the_wrapper(standin, rows):
    """csrc/colband.cu's colband_params admits a window of RW rows to the
    instance exactly when `max_threads`, the wrapper's copy of its launch
    bound, does (GB 0: nothing runs)."""
    z = np.zeros(8, np.int32)
    for RW in range(8, 4097, 8):
        ok = standin.run(z.ctypes.data, z.ctypes.data, z.ctypes.data,
                         z.ctypes.data, 0, 8, 8, RW, 8, 8, 0, 1, 4, 8, 2,
                         3, 400, 63, rows, None) == 0
        assert ok == (cb.block_threads(RW, rows) <= cb.max_threads(rows)), \
            RW


# colband_torch's and the oracle's results by bucket: every instance
# of a case sweeps the same bucket (the rng fixture restarts per test)
_REFS: dict = {}


def _reference(pairs, meta, tcodes, qfwd, jcfg, cfg, shapes):
    key = (meta.tobytes(), tcodes.tobytes(), qfwd.tobytes(), repr(jcfg))
    if key not in _REFS:
        ref = cb.colband_torch(
            torch.from_numpy(cb.chain_scalars(meta, cfg)),
            torch.from_numpy(tcodes), torch.from_numpy(qfwd), cfg,
            shapes).numpy()
        oracle = [tuple(align_one_sweep(qc, tc, ql, rl, jcfg))
                  for qc, tc, ql, rl in pairs[:meta.shape[0]]]
        _REFS[key] = ref, oracle
    return _REFS[key]


def check(lib, pairs, jcfg, rows, n=None, split=False):
    """The instance of `rows` rows a thread on the stand-in ==
    colband_torch == the oracle (first three columns) on the first n
    pairs of the bucket; returns the shapes."""
    cfg = config_from(jcfg)
    meta, tcodes, qfwd = tk.build_bucket_arrays(pairs, cfg)
    if n is not None:
        meta, tcodes, qfwd = (a[:n].copy() for a in (meta, tcodes, qfwd))
    got, shapes = run_colband(lib, meta, tcodes, qfwd, cfg, rows, split)
    ref, oracle = _reference(pairs, meta, tcodes, qfwd, jcfg, cfg, shapes)
    bad = np.nonzero((got != ref).any(axis=1))[0]
    assert bad.size == 0, (bad[:5], got[bad[:5]], ref[bad[:5]])
    for p, exp in enumerate(oracle):
        assert tuple(got[p, :3]) == exp, p
    return shapes


def _long(rng, n, lo, hi):
    out = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(lo, hi)), 0.01)
        t = (mutate(rng, q) if i % 3 else
             random_seq(rng, int(rng.integers(lo, hi)), 0.01))
        out.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return out


def _cfg(bw, z=400, **kw):
    base = dict(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3)
    base.update(kw)
    return JaxAlignConfig(z_threshold=z, band_width=bw, **base)


def test_colband_standin_bw63_mixed(standin, rng, rows):
    check(standin, _pairs(rng, n=24, lo=8, hi=300), BW63, rows)


def test_colband_standin_bw31_empty_slices(standin, rng, rows):
    check(standin, _unrelated(rng, EMPTY_SLICE_SHAPES),
          _cfg(31, 20), rows)


@pytest.mark.parametrize("jcfg", [JAX_CONFIGS[3], JAX_CONFIGS[5]],
                         ids=["m2x3q5r1s5", "m3x5-bw127"])
def test_colband_standin_any_gb_all_n_and_padding(standin, rng, jcfg, rows):
    pairs = [(encode_padded("N" * 50), encode_padded("ACGT" * 15), 50, 60),
             (encode_padded("N" * 33), encode_padded("N" * 33), 33, 33),
             (encode_padded("A"), encode_padded("A"), 1, 1)]
    pairs += _pairs(rng, n=8, lo=1, hi=420)
    check(standin, pairs, jcfg, rows, n=11)


@pytest.mark.parametrize("bw, lo, hi, n, warps", [
    (127, 500, 1000, 6, 2),    # a partial second warp
    (255, 700, 1300, 5, 3),
    (751, 1600, 2000, 2, 6),   # the headline's window, RW 1536
])
def test_colband_standin_rolling_window_across_warps(standin, rng, bw, lo,
                                                     hi, n, warps, rows):
    """Windows of several row warps that roll: every roll hands the
    first 8 / R threads' rows of each warp to the last 8 / R threads of
    the warp above (`warps` counts the row warps at 8 rows a thread; an
    instance of fewer rows a thread has more)."""
    shapes = check(standin, _long(rng, n, lo, hi), _cfg(bw), rows)
    RW, gA, gB = shapes[0], shapes[4], shapes[5]
    assert -(-RW // 256) == warps and gB > gA
    assert -(-RW // (32 * rows)) >= warps


def _offset_pair(rng, n, at, gap):
    """A homologous pair whose path leaves the main diagonal by `gap`
    rows (a target insertion; a query insertion if negative) after
    `at` bases, and stays there."""
    s = random_seq(rng, n, 0.0)
    ins = random_seq(rng, abs(gap), 0.0)
    q, t = (s, s[:at] + ins + s[at:]) if gap > 0 else \
        (s[:at] + ins + s[at:], s)
    return (encode_padded(q), encode_padded(t), len(q), len(t))


@pytest.mark.parametrize("bw, gaps", [
    (751, (-4, 252, 300, -260)),
    (255, (-20, 236, 260)),
])
def test_colband_standin_paths_on_warp_boundaries(standin, rng, bw, gaps,
                                                  rows):
    """Paths that run along the last rows of a warp of 8 rows a thread
    while the window rolls (row r sits at window row LEAD + r - j; those
    of warp w's last thread are 256 w - 8 .. 256 w - 1), and vertical
    gaps longer than a warp's 256 rows: the rolled rows and the E carry
    cross warps."""
    pairs = [_offset_pair(rng, int(rng.integers(1100, 1500)), 150, g)
             for g in gaps]
    shapes = check(standin, pairs, _cfg(bw), rows)
    LEAD = shapes[7]
    assert any(0 <= (LEAD + g) % 256 >= 248 for g in gaps)


@pytest.mark.parametrize("bw", [180, 255])
def test_colband_standin_paths_on_each_instances_boundaries(standin, rng,
                                                            bw, rows):
    """For the instance's own warps of 32 R rows: paths on the last 8
    rows of a warp (the rows its last 8 / R threads take from the next
    warp at every roll), on a warp's first thread, and on the last row
    of a row block that two threads share (R < 8)."""
    span = 32 * rows
    LEAD = -(-(bw + 16) // 8) * 8
    # window row LEAD + gap (+ 0..7 within a group) lands on `want`
    gaps = [(want - LEAD + span // 2) % span - span // 2
            for want in (span - 8, span - 1, 0, 4)]
    pairs = [_offset_pair(rng, int(rng.integers(900, 1200)), 120, g)
             for g in gaps]
    shapes = check(standin, pairs, _cfg(bw), rows)
    assert shapes[0] > span and shapes[5] > shapes[4]


def test_colband_standin_chain_past_the_padded_extent(standin, rng, rows):
    """Slice width 4 and ~250 bp pairs: the chain's end cap end_p = 520
    lies past R8pad + Qpad = 512, and the chain lane replays up to it."""
    pairs = []
    for n in (250, 252, 255):
        q = random_seq(rng, n)
        t = "".join("ACGT"[int(rng.integers(0, 4))] if rng.random() < 0.05
                    else ch for ch in q)
        pairs.append((encode_padded(q), encode_padded(t), n, n))
    jcfg = _cfg(63, slice_width=4)
    check(standin, pairs, jcfg, rows, n=len(pairs))
    meta = tk.build_bucket_arrays(pairs, config_from(jcfg))[0]
    assert (cb.chain_scalars(meta, config_from(jcfg))[4, :3] > 512).all()


def test_colband_standin_zdrop_inside_a_group(standin, rng, rows):
    """Tight Z-drop on unrelated tails: the chain lane stops the sweep
    at a group's start, several warps wide."""
    pairs = []
    for i in range(5):
        s = random_seq(rng, int(rng.integers(300, 500)), 0.0)
        q = s + random_seq(rng, int(rng.integers(300, 700)))
        t = s + random_seq(rng, int(rng.integers(300, 700)))
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    check(standin, pairs, _cfg(255, z=30), rows)


RANDOM_CFGS = [
    _cfg(31, 20), _cfg(63), _cfg(101, 20), _cfg(127, 800, match=3,
                                                mismatch=5, gap_open=4,
                                                slice_width=4),
    _cfg(55, 150, match=2, mismatch=3, gap_open=5, gap_extend=1,
         slice_width=5),
    _cfg(255, 60, slice_width=1), _cfg(180, -1, slice_width=2),
]


@pytest.mark.parametrize("seed", range(20))
def test_colband_standin_random(standin, seed, rows):
    """20 seeded buckets: bw 31-255 (one to three row warps), homologous
    and unrelated pairs up to 900 bp (the window rolls), N runs, z < 0
    and tight Z-drops, GB not a multiple of 8."""
    rng = np.random.default_rng(9000 + seed)
    jcfg = RANDOM_CFGS[seed % len(RANDOM_CFGS)]
    n = int(rng.integers(1, 8))
    pairs = _pairs(rng, n=n, lo=8, hi=int(rng.choice([200, 500, 900])))
    if seed % 4 == 0:
        q = random_seq(rng, 120) + "N" * 30 + random_seq(rng, 100)
        t = mutate(rng, q)
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    check(standin, pairs, jcfg, rows, n=len(pairs))


def test_colband_standin_split_instance(standin, rng, rows):
    """The clock64 instance of each R sweeps the same bucket (a rolling
    window of two to five row warps) to the same outputs."""
    check(standin, _long(rng, 3, 500, 900), _cfg(127), rows, split=True)


def _synthetic_diag(rng, n, z, drop_at=None, ties=False):
    """Per-diagonal maxima (th << 16) + tr of n diagonals along the main
    diagonal (tr = d // 2): scores that climb with noise well inside z,
    a few never-written diagonals (INT32_MIN), a drop past z at
    `drop_at`, and with `ties` runs of diagonals equal to the carried
    best and equal new bests in one round."""
    d = np.arange(n, dtype=np.int64)
    th = 5 + (d * 3) // 5 - rng.integers(0, 6, n)
    if ties:
        for k in rng.choice(np.arange(20, n - 8), 6, replace=False):
            th[k:k + 4] = th[:k].max() + (10 if k % 2 else 0)
    if drop_at is not None:
        th[drop_at] = th[:drop_at].max() - (z + 50)
    x = (th << 16) + d // 2
    x[rng.choice(np.arange(16, n), n // 20, replace=False)] = -(1 << 31)
    if drop_at is not None:
        x[drop_at] = (th[drop_at] << 16) + drop_at // 2
    return x.astype(np.int32)


CHAIN_CASES = {
    # name: (diagonals, z, drop_at, ties)
    "end-cap-lane0": (257, 200, None, False),
    "end-cap-lane16": (273, 200, None, False),
    "end-cap-lane30": (287, 200, None, False),
    "no-zdrop": (300, -1, None, False),
    "zdrop-lane0": (320, 200, 192, False),
    "zdrop-lane31": (320, 200, 223, False),
    "zdrop-lane13": (320, 200, 205, False),
    "zdrop-beside-end-cap": (301, 200, 298, False),
    "ties": (300, 200, None, True),
}


@pytest.mark.parametrize("step", [8, 16, 32])
@pytest.mark.parametrize("case", list(CHAIN_CASES), ids=list(CHAIN_CASES))
def test_colband_standin_chain_round(standin, case, step):
    """The chain warp's rounds (csrc/colband.cu chain_round) against the
    plain replay `chain_replay_torch` on synthetic per-diagonal maxima:
    rounds of 8 and 16 diagonals (a group's worth during the sweep) and
    32 (the tail), the end cap end_p and Z-drops at the first, last and
    a middle lane of a round and beside the end cap, diagonals at
    n_diags .. i_end8 - 1 (counted, not replayed) holding the highest
    scores, never-written diagonals, and ties (the earlier diagonal
    wins, the carried best over a round's)."""
    n, z, drop_at, ties = CHAIN_CASES[case]
    ge = 2
    rng = np.random.default_rng(sum(map(ord, case)))
    diag = _synthetic_diag(rng, n, z, drop_at, ties)
    end_p, i_end8 = n, n - 8
    n_diags = i_end8 - 5
    diag[n_diags:i_end8] = (30000 << 16) + n_diags // 2
    rs = 64
    while rs < n:
        rs <<= 1
    got = np.zeros(4, np.int32)
    standin.chain(diag.ctypes.data, n, rs, i_end8, n_diags, end_p, z, ge,
                  step, got.ctypes.data)
    cfg = AlignConfig(z_threshold=z, gap_extend=ge)
    gate = torch.tensor([[i_end8], [n_diags], [end_p]], dtype=torch.int32)
    ref = cs.chain_replay_torch(torch.from_numpy(diag)[:, None], gate[0],
                                gate[1], gate[2], cfg)[0].numpy()
    assert got.tolist() == ref.tolist()
    assert got[3] == (drop_at + 1 if drop_at is not None else end_p)


# --- the cost probe P2: csrc/colband.cu probe_kernel ---------------------

PROBE_SWITCHES = {
    "full": {}, "no-chain": {"with_chain": False},
    "window-8": {"n_prefix": 3}, "no-ring": {"with_ring": False},
    "bare": {"n_prefix": 1, "with_ring": False, "with_chain": False},
}
# windows of one row warp (at every R) to 12 (R = 2 at RW 768, where
# rows pass the placeholder mask's upper end); ragged column counts: a
# whole pair, one ending inside a group, one at a group's end, one empty
PROBE_RWS = (64, 200, 384, 768)
PROBE_NCOLS = 64
PROBE_META = np.array([[64, 51, 40, 0], [PROBE_NCOLS] * 4], np.int32)
PROBE_PREV = (np.arange(4, dtype=np.int32)[:, None] * 7
              + np.arange(4, dtype=np.int32)[None, :] * 1001)


def run_probe(lib, meta, prev, RW, ncols, rows, *, with_chain=True,
              n_prefix=None, with_ring=True):
    """The probe instance's (4, N) output and (3 RW + 16, N) final state
    on the CPU."""
    n = meta.shape[1]
    out = np.full((4, n), -7, np.int32)
    state = np.full((3 * RW + 16, n), -7, np.int32)
    assert lib.probe(meta.ctypes.data, prev.ctypes.data, out.ctypes.data,
                     state.ctypes.data, n, RW, ncols, int(with_chain),
                     colband_probe.instance_prefix(RW, n_prefix),
                     int(with_ring), rows) == 0
    return out, state


_PROBE_REFS: dict = {}


def _probe_reference(variant, RW):
    if (variant, RW) not in _PROBE_REFS:
        out, state = colband_probe.colband_probe_torch(
            torch.from_numpy(PROBE_META), torch.from_numpy(PROBE_PREV), RW,
            PROBE_NCOLS, return_state=True, **PROBE_SWITCHES[variant])
        _PROBE_REFS[variant, RW] = out.numpy(), state.numpy()
    return _PROBE_REFS[variant, RW]


@pytest.mark.parametrize("variant", list(PROBE_SWITCHES))
def test_colband_standin_probe_equals_plain(standin, variant, rows):
    """P2's instance of R rows a thread under each switch set (the one
    the launcher's probe_instance picks) == colband_probe_torch: the
    four outputs and the final H, F and ring (every entry below the last
    group's 16 g reset, as the plain version's shifts drop them), at
    windows of one to 12 row warps, with ragged column counts."""
    switches = PROBE_SWITCHES[variant]
    for RW in PROBE_RWS:
        got, state = run_probe(standin, PROBE_META, PROBE_PREV, RW,
                               PROBE_NCOLS, rows, **switches)
        ref, ref_state = _probe_reference(variant, RW)
        assert np.array_equal(got, ref), (RW, got, ref)
        bad = np.nonzero((state != ref_state).any(axis=1))[0]
        assert bad.size == 0, (RW, bad[:8])


def test_colband_standin_probe_launch_bound_matches_the_wrapper(standin,
                                                                rows):
    """csrc/colband.cu's probe_params admits a window of RW rows to the
    instance of R rows a thread exactly when the wrapper's `probe_rows`
    does (n 0: nothing runs)."""
    z = np.zeros(8, np.int32)
    for RW in range(8, 4097, 8):
        ok = standin.probe(z.ctypes.data, z.ctypes.data, z.ctypes.data,
                           None, 0, RW, 8, 1, -1, 1, rows) == 0
        try:
            want = colband_probe.probe_rows(RW, rows) == rows
        except ValueError:
            want = False
        assert ok == want, RW


def _probe_segments(rng, n_seg, drop_at=None, ties=False, unwritten=None):
    """n_seg segments of 16 ring entries (th << 16) + tr along the main
    diagonal (tr = d // 2 for diagonal d = 16 s - 8 + l): scores that
    climb with noise well inside the probe's Z, with `ties` runs equal
    to the best so far, a drop past Z at `drop_at`, and a never-written
    entry (INT32_MIN) at each index in `unwritten`: the probe's chain
    takes one as a drop while its best is still at target row 0, as in
    its first group."""
    n = 16 * n_seg
    d = np.arange(n, dtype=np.int64) - 8
    th = 5 + (d * 3) // 5 - rng.integers(0, 6, n)
    if ties:
        for k in rng.choice(np.arange(20, n - 8), 6, replace=False):
            th[k:k + 4] = th[:k].max() + (7 if k % 2 else 0)
    if drop_at is not None:
        th[drop_at] = th[:drop_at].max() - (colband_probe.Z + 60)
    x = (th << 16) + np.maximum(d, 0) // 2
    x[list(unwritten or ())] = -(1 << 31)
    return x.astype(np.int32)


@pytest.mark.parametrize("case", [
    ("climb", None, False, None), ("ties", None, True, None),
    ("drop-lane0", 16 * 5, False, None),
    ("drop-lane15", 16 * 5 + 15, False, None),
    ("drop-lane7-ties", 16 * 6 + 7, True, None),
    ("unwritten", None, True, (9, 16 * 7 + 9)),
], ids=lambda c: c[0])
def test_colband_standin_probe_segment_chain(standin, case):
    """The chain warp's probe_segment over 12 segments against the plain
    `_vchain`, carry by carry: the first-wins running argmax seeded with
    the carry (ties), a Z-drop candidate at a segment's first, last and a
    middle row, never-written entries, and the carried `term` that makes
    every later row a candidate."""
    name, drop_at, ties, unwritten = case
    rng = np.random.default_rng(sum(map(ord, name)))
    n_seg = 12
    seg = _probe_segments(rng, n_seg, drop_at, ties, unwritten)
    got = np.zeros((n_seg, 5), np.int32)
    standin.probe_chain(seg.ctypes.data, n_seg, got.ctypes.data)
    z0 = torch.zeros((1, 1), dtype=torch.int32)
    carry = (z0, z0, z0, z0, z0)
    for s in range(n_seg):
        ring = torch.from_numpy(seg[16 * s:16 * s + 16].copy())[:, None]
        carry = colband_probe._vchain(ring, 16 * s - 8, carry)
        want = [int(v) for v in carry]
        assert got[s].tolist() == want, (s, got[s], want)
    first = min([drop_at or 16 * n_seg, *(unwritten or ())]) // 16
    assert got[:, 3].tolist() == [int(s >= first) for s in range(n_seg)]
