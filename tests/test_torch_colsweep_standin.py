"""csrc/colsweep.cu itself (B4 sweep, B5 chain), compiled with g++
against the stand-in for the CUDA built-ins of
tests/test_torch_antidiag_standin.py, against the plain versions
`colsweep_sweep_torch` / `colsweep_chain_torch` and the oracle on the CPU.

The kernels' source is used as it is up to their launch helpers; the
lines declaring the dynamic shared memory are rewritten to a buffer of
the launch, filled with garbage before every block, and the ring the
sweep writes starts as garbage, so an entry it fails to write shows.
One fiber per CUDA thread runs the sweep's lane wavefront (its two
shuffles a step), the shared-memory instance's column scan and the
chain's prefix over lanes, ballot and early exit.  Fibers switch only at
the warp built-ins, so the shared-memory atomicMax of the ring merge
cannot race here: the card-side checks (chip_smoke.py phase 5b, the
`cuda` tests) hold the boundary-row case that would show a lost merge.

Buckets: every register instance (2, 4, ..., 32 rows a lane) and the
shared-memory one, with target lengths at and beside multiples of 32 and
of 8; all-N pairs and 1x1 padding rows; GB not a multiple of the pairs
a block; z = 20 and the canonical z; the -m2 -x3 -q5 -r1 -s5 -w911
config; identical pairs, whose lane-boundary rows hold their diagonals'
maxima; seeded random buckets.  The chain also runs alone on synthetic
rings: Z-drops in the first and the 32nd lane of a round, and random
rings.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from agatha_tpu_torch.config import AlignConfig
from agatha_tpu_torch.ops import colsweep as cs
from agatha_tpu_torch.ops import kernel as tk
from agatha_tpu_torch.ops.packing import encode_padded
from agatha_tpu_torch.ops.sweep import align_one_sweep

from .conftest import mutate, random_seq
from .test_torch_antidiag_standin import CSRC, compile_standin

torch.set_num_threads(1)

DRIVER = r"""
#include <algorithm>
#include "cuda_runtime.h"
static int* g_dyn;
#include "kernel_body.inc"
extern "C" int sweep(const void* meta, const void* tcodes, const void* qfwd,
                     void* ring, int gb, int wt, int qf, int R, int Q,
                     int d_pad, int wpb, int k_rows, int match,
                     int mismatch, int goe, int ge, int sw) {
  SweepParams p;
  p.meta = static_cast<const int32_t*>(meta);
  p.tcodes = static_cast<const uint8_t*>(tcodes);
  p.qfwd = static_cast<const uint8_t*>(qfwd);
  p.ring = static_cast<int32_t*>(ring);
  p.gb = gb; p.wt = wt; p.qf = qf; p.R = R; p.Q = Q; p.d_pad = d_pad;
  p.wpb = wpb; p.match = match; p.mismatch = mismatch; p.goe = goe;
  p.ge = ge; p.sw = sw;
  void (*kern)(const SweepParams);
  switch (k_rows) {
#define CASE(k) case k: kern = sweep_regs_kernel<k>; break;
    CASE(4) CASE(8) CASE(12) CASE(16) CASE(20) CASE(24) CASE(28) CASE(32)
#undef CASE
    case 0: kern = sweep_smem_kernel; break;
    default: return 1;
  }
  const size_t ints = k_rows ? regs_warp_ints(d_pad, Q) * wpb
                             : (3 * state_rows(R) + d_pad) * wpb;
  std::vector<int> dyn(ints);
  g_dyn = dyn.data();
  for (int b = 0; b < (gb + wpb - 1) / wpb; ++b) {
    std::fill(dyn.begin(), dyn.end(), 0x5A5A5A5A);
    run_block(b, wpb * 32, [&] { kern(p); });
  }
  return 0;
}
extern "C" int chain(const void* meta, const void* ring, void* out, int gb,
                     int d_pad, int sw, int z, int ge) {
  for (int b = 0; b < (gb + kChainWarps - 1) / kChainWarps; ++b)
    run_block(b, kChainWarps * 32, [&] {
      chain_kernel(static_cast<const int32_t*>(meta),
                   static_cast<const int32_t*>(ring),
                   static_cast<int32_t*>(out), gb, d_pad, sw, z, ge);
    });
  return 0;
}
"""


def cfg_of(bw=751, z=400, **kw):
    base = dict(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3)
    base.update(kw)
    return AlignConfig(z_threshold=z, band_width=bw, **base)


CANON = cfg_of()
# bands past 1023 rows reach the largest register instance (K = 32) and
# the shared-memory one; still int16-safe at these widths
WIDE = cfg_of(bw=1200)
OTHER = cfg_of(bw=911, z=150, match=2, mismatch=3, gap_open=5,
               gap_extend=1, slice_width=5)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    d = tmp_path_factory.mktemp("colsweep_standin")
    with open(os.path.join(CSRC, "colsweep.cu")) as f:
        src = f.read()
    body = src[:src.index("using SweepKernel = ")]
    body, n = re.subn(r"extern __shared__ int smem\[\];",
                      "int* const smem = g_dyn;", body)
    assert n == 2  # the register and shared-memory instances
    lib = compile_standin(d, body + "}  // namespace\n", DRIVER)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sweep.argtypes = [vp] * 4 + [ci] * 13
    lib.sweep.restype = ci
    lib.chain.argtypes = [vp] * 3 + [ci] * 5
    lib.chain.restype = ci
    return lib


def run_sweep(lib, meta, tcodes, qfwd, cfg, shapes):
    """The sweep kernel's ring as (d_pad, GB), the wrapper's view of the
    pair-major buffer it writes, and the instance (rows a lane) taken."""
    R, Q, d_pad = shapes
    k_rows, wpb = cs.sweep_launch(shapes)
    gb = meta.shape[0]
    ring = np.full((gb, d_pad), 0x5A5A5A5A, np.int32)
    assert lib.sweep(meta.ctypes.data, tcodes.ctypes.data,
                     qfwd.ctypes.data, ring.ctypes.data, gb,
                     2 * tcodes.shape[1], 2 * qfwd.shape[1], R, Q, d_pad,
                     wpb, k_rows, cfg.match, cfg.mismatch, cfg.gap_oe,
                     cfg.gap_extend, cfg.slice_width) == 0
    return ring.T, k_rows


def run_chain(lib, meta, ring, cfg):
    """The chain kernel's (GB, 4) rows over a (d_pad, GB) ring."""
    pair_major = np.ascontiguousarray(ring.T, np.int32)
    gb, d_pad = pair_major.shape
    out = np.full((gb, 4), -7, np.int32)
    assert lib.chain(np.ascontiguousarray(meta, np.int32).ctypes.data,
                     pair_major.ctypes.data, out.ctypes.data, gb, d_pad,
                     cfg.slice_width, cfg.z_threshold, cfg.gap_extend) == 0
    return out


def check(lib, pairs, cfg, n=None, oracle=3):
    """Stand-in ring == plain ring, stand-in rows == plain rows (on the
    plain ring), and the first `oracle` pairs == align_one_sweep; the
    bucket is cut to its first n pairs.  Returns (instance, ring, rows)."""
    meta, tcodes, qfwd = tk.build_bucket_arrays(pairs, cfg)
    if n is not None:
        meta, tcodes, qfwd = (a[:n].copy() for a in (meta, tcodes, qfwd))
    w, qf = 2 * tcodes.shape[1], 2 * qfwd.shape[1]
    assert cs.bucket_eligible(meta, w, qf, cfg)
    shapes = cs.colsweep_shapes(meta, tcodes, qfwd, cfg)
    ring, k_rows = run_sweep(lib, meta, tcodes, qfwd, cfg, shapes)
    args = tuple(torch.from_numpy(a) for a in (meta, tcodes, qfwd))
    ring_ref = cs.colsweep_sweep_torch(*args, cfg, shapes).numpy()
    bad = np.nonzero((ring != ring_ref).any(axis=0))[0]
    assert bad.size == 0, ("ring", k_rows, bad[:5])
    rows = run_chain(lib, meta, ring_ref, cfg)
    rows_ref = cs.colsweep_chain_torch(args[0], torch.from_numpy(ring_ref),
                                       cfg).numpy()
    bad = np.nonzero((rows != rows_ref).any(axis=1))[0]
    assert bad.size == 0, ("rows", bad[:5], rows[bad[:5]], rows_ref[bad[:5]])
    for p, (qc, tc, ql, rl) in enumerate(pairs[:min(oracle, len(meta))]):
        assert tuple(rows[p, :3]) == tuple(align_one_sweep(qc, tc, ql, rl,
                                                           cfg)), p
    return k_rows, ring, rows


def enc(q, t):
    return encode_padded(q), encode_padded(t), len(q), len(t)


def pairs_at(rng, rlens, qlo, qhi, n_frac=0.01):
    """One pair per target length: homologous (a mutated query cut or
    padded to that length) for even positions, unrelated for odd."""
    out = []
    for i, rl in enumerate(rlens):
        q = random_seq(rng, int(rng.integers(qlo, qhi)), n_frac)
        t = mutate(rng, q) if i % 2 == 0 else ""
        t = (t + random_seq(rng, rl, n_frac))[:rl]
        out.append(enc(q, t))
    return out


@pytest.mark.parametrize("end", ["top", "bottom"])
@pytest.mark.parametrize("k_rows", cs.SWEEP_REG_ROWS + (0,))
def test_colsweep_standin_each_instance(standin, rng, k_rows, end):
    """Target lengths at, one below and one above multiples of 32 and 8,
    at the top of the instance's rows (32 * k_rows; the shared-memory
    instance at 1120) or just past the next instance down's, where the
    last lanes hold no row; GB = 7, not a multiple of the pairs a block."""
    if end == "top":
        top = 32 * k_rows if k_rows else 1120
        rlens = [top, top - 1, top - 7, top - 8, top - 9, top - 31, top - 33]
    else:
        low = 32 * (k_rows - 4) + 1 if k_rows else 1025
        top = low + 33
        rlens = [top, low, low + 1, low + 7, low + 8, low + 9, low + 31]
    pairs = pairs_at(rng, rlens, 20, 90)
    q = random_seq(rng, max(top - 40, 8), 0.01)  # a near-square pair
    pairs[2] = enc(q, mutate(rng, q)[:rlens[2]])
    got, _ring, _rows = check(standin, pairs, WIDE, n=7)
    assert got == k_rows


@pytest.mark.parametrize("cfg", [CANON, cfg_of(z=20), OTHER],
                         ids=["canonical", "z20", "m2x3q5r1s5w911"])
@pytest.mark.parametrize("lo, hi", [(1, 170), (560, 753)])
def test_colsweep_standin_configs(standin, cfg, lo, hi):
    rng = np.random.default_rng(hi + cfg.band_width + cfg.z_threshold)
    pairs = []
    for i in range(10):
        q = random_seq(rng, int(rng.integers(lo, hi)), 0.03)
        t = (mutate(rng, q) if i % 3 else
             random_seq(rng, int(rng.integers(lo, hi)), 0.03))
        pairs.append(enc(q[:752], t[:752] or "A"))
    check(standin, pairs, cfg, n=10)


def test_colsweep_standin_all_n_and_padding(standin, rng):
    pairs = [enc("N" * 50, random_seq(rng, 60)),
             enc(random_seq(rng, 70), "N" * 40),
             enc("N" * 33, "N" * 33),
             enc(random_seq(rng, 90, 0.3), random_seq(rng, 85, 0.3)),
             enc("A", "A"), enc("C", "G")]
    k_rows, ring, rows = check(standin, pairs, CANON, oracle=6)
    meta = tk.build_bucket_arrays(pairs, CANON)[0]
    assert meta.shape[0] > len(pairs)  # 1x1 padding rows follow
    assert (meta[len(pairs):] == 1).all()


@pytest.mark.parametrize("n", [150, 600, 1000])
def test_colsweep_standin_lane_boundary_maxima(standin, rng, n):
    """Identical pairs: diagonal 2r has its max at row r, so the last row
    of each lane (r = L*K + K - 1) holds the max of a diagonal that the
    next lane's first row merges into in the same step."""
    cfg = WIDE if n > 752 else CANON
    s = random_seq(rng, n)
    pairs = [enc(s, s), enc(s[: n - 3], s[: n - 3])]
    k_rows, ring, _rows = check(standin, pairs, cfg, oracle=2)
    assert k_rows
    boundary = np.arange(k_rows - 1, n - 1, k_rows)
    best_row = ring[2 * boundary, 0] & 0xFFFF
    assert (best_row == boundary).all()


@pytest.mark.parametrize("seed", range(6))
def test_colsweep_standin_random(standin, seed):
    rng = np.random.default_rng(9100 + seed)
    cfg = [CANON, cfg_of(z=20), OTHER][seed % 3]
    hi = int(rng.choice([100, 300, 753]))
    pairs = []
    for i in range(int(rng.integers(1, 9))):
        q = random_seq(rng, int(rng.integers(1, hi)), 0.05)
        t = (mutate(rng, q) if i % 2 else
             random_seq(rng, int(rng.integers(1, hi)), 0.05))
        pairs.append(enc(q[:752], t[:752] or "T"))
    check(standin, pairs, cfg)


def _chain_case(cfg, gb, d_pad, qlen=60, rlen=60):
    meta = np.tile(np.array([[qlen, rlen]], np.int32), (gb, 1))
    ring = np.full((d_pad, gb), np.iinfo(np.int32).min, np.int32)
    return meta, ring


def _pack(th, tr):
    return np.int32(np.uint32(((th & 0xFFFF) << 16) | tr).view(np.int32))


@pytest.mark.parametrize("stop_at", [0, 31, 32, 63, 95])
def test_colsweep_standin_chain_zdrop_lanes(standin, stop_at):
    """A Z-drop at the first (d = 0, 32) and the 32nd (d = 31, 63, 95)
    lane of a round: the best (50 at row 1, diagonal 3) is carried into
    later rounds, ties with it neither update nor stop."""
    cfg = cfg_of(z=20)
    meta, ring = _chain_case(cfg, 2, 256)
    if stop_at == 0:
        ring[0, 0] = _pack(-30, 0)
    else:
        ring[:3, 0] = _pack(0, 0)  # no gain, no drop
        ring[3, 0] = _pack(50, 1)  # ms 50, mr 1, mq 2
        ring[4:stop_at, 0] = _pack(50, 2)
        x = (stop_at - 3) // 2  # tr - mr and dq - mq differ by at most 1
        ring[stop_at, 0] = _pack(0, 1 + x)
    ring[:, 1] = ring[:, 0]
    ring[5, 1] = _pack(60, 2)  # a later best in pair 1 moves its stop
    got = run_chain(standin, meta, ring, cfg)
    ref = cs.colsweep_chain_torch(torch.from_numpy(meta),
                                  torch.from_numpy(ring), cfg).numpy()
    assert (got == ref).all(), (got, ref)
    assert got[0, 3] == stop_at + 1


@pytest.mark.parametrize("seed", range(8))
def test_colsweep_standin_chain_random_rings(standin, seed):
    """Random rings (scores -40..60, rows up to the diagonal, unreached
    entries) over random pair shapes and z, against the plain chain."""
    rng = np.random.default_rng(9300 + seed)
    cfg = cfg_of(z=int(rng.choice([-1, 0, 10, 30])),
                 slice_width=int(rng.integers(1, 5)))
    gb = int(rng.integers(1, 11))
    meta = rng.integers(1, 200, size=(gb, 2)).astype(np.int32)
    d_pad = 128 * int(rng.integers(4, 6))
    d = np.arange(d_pad)[:, None]
    th = rng.integers(-40, 61, size=(d_pad, gb))
    tr = (rng.random((d_pad, gb)) * (d + 1)).astype(np.int64)
    ring = ((th & 0xFFFF) << 16 | tr).astype(np.uint32).view(np.int32)
    ring[rng.random((d_pad, gb)) < 0.1] = np.iinfo(np.int32).min
    got = run_chain(standin, meta, ring, cfg)
    ref = cs.colsweep_chain_torch(torch.from_numpy(meta),
                                  torch.from_numpy(ring), cfg).numpy()
    assert (got == ref).all(), np.nonzero((got != ref).any(axis=1))[0]
