"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (`agatha_tpu_torch.engine.AlignEngine.align`,
score only and with device traceback) on the card and checks them, in
phases; each prints its seconds, and any mismatch raises (non-zero
exit):

0. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
1. build: nvcc compiles csrc/antidiag.cu, csrc/colsweep.cu,
   csrc/walk.cu, csrc/colband.cu (B7 and the probe instances) and
   csrc/substep_probe.cu (P3, P4) for sm_90a, in parallel, and all are
   loaded (ptxas registers / spills);
2. the kernel against its plain PyTorch version on the card, exactly,
   on small full-width, strip-path, windowed, asymmetric, all-N and
   padding buckets;
3. the kernel against the NumPy oracle `align_one_sweep`, exactly;
3b. the kernel against its plain version (on the CPU, same inputs, in a
   pool of host processes while the next kernels launch) on
   200 seeded random buckets (slice widths 1-4, bw 36-751, z < 0, full
   width and windowed, safe16 and forced strips, all-N and 1-code
   pairs), every fifth also with flags, whose words the walk (B6) gives
   too;
4. the headline: 1024 pairs of ~10 kb, -m1 -x4 -q6 -r2 -s3 -z400 -w751,
   through the engine on the card: one kernel launch per bucket, wall
   ms and GCUPS (best of 3 after one warm-up), per-bucket CUDA-event ms,
   the 4 shortest pairs against the oracle and the fewest-diagonal
   bucket against the plain version, with both versions' times;
5. the colsweep kernels (B4 sweep, B5 chain) against their plain
   versions on the card, ring and rows exactly: 150, 600 and 740-752 bp,
   tight z, a second scoring config, all-N and 1x1 padding rows, GB not
   a multiple of 128, then at bw 1200 the largest register instances of
   B4 (900-1024 bp) and its shared-memory instance (1030-1120 bp);
5b. B4 and B5 against their plain versions (on the card, same tensors)
   on 200 seeded random colsweep-eligible buckets: lengths 1-752, GB
   1-600, three configs, N runs, every tenth with identical pairs whose
   lane-boundary rows hold their diagonals' maxima (the rows two lanes
   merge into one diagonal in the same step), every eighth bucket's
   first two pairs against the oracle;
6. the colsweep route against the NumPy oracle, exactly;
7. short reads through the engine: 8192 x 150 bp and 8192 x 600 bp
   (make_workload spread 0.05), every bucket routed to colsweep with one
   sweep and one chain launch each, all four fields equal to the engine
   with colsweep off (the antidiagonal kernel), wall ms, reads/s, GCUPS,
   per-bucket CUDA-event ms, a host-clock split of one align() (packing,
   copies, launches, collect), then one bucket's B4 and B5 against their
   plain versions (CUDA-event ms, device ms by CUDA-graph replay
   beside);
8. the traceback kernels against their plain versions on the card: the
   flag-emitting antidiagonal kernel (B3) on small full-width, strip-
   path, windowed, asymmetric, leading-gap, all-N and padding buckets
   (results, every swept flag plane and the walked move words exactly),
   the walk (B6) on each kernel bitmap against `walk_torch`;
8b. B6 against `walk_torch` (on the CPU, same bitmaps) on seeded random
   buckets at the headline's width: B3's bitmaps of 1.1-2.2 kb pairs at
   bw 751 (windowed, the window origin shifting, paths that end in
   leading gaps) and random bitmaps of 1024 lanes with vbase shifts;
9. the headline with CIGARs: the same 1024 pairs through
   `align(traceback=True)`: every bucket routed to the walk, one B3 and
   one B6 launch each, scores and ends equal to the score-only run,
   every CIGAR rescored (vectorised) to its score and consuming
   q_end + 1 / t_end + 1, CIGAR scores equal to traceback_mode="host";
   the traceback wall (best of 3) against the score wall measured before
   and after it (the smaller), B3 and B6 CUDA-event ms per bucket, the
   peak allocated memory; then B3 and B6 on the fewest-diagonal bucket
   (1536 planes) against their plain versions;
10. 8192 x 150 bp with CIGARs (B3 full width), the same checks;
11. the banded column-sweep kernel (B7), every instance (R = 2, 4, 8
    rows a thread, where the window fits a block),
    against one plain result `colband_torch` on the card, exactly, then
    the engine's instance against the oracle and the antidiagonal kernel
    (all four columns): bw 63 with 24 mixed pairs, bw 31 with z 20 and
    shapes that reach the empty-slice cap, bw 751 with 400-3000 bp pairs
    (the window rolls), all-N and 1x1 padding rows, GB = 37, a second
    scoring config (-m2 -x3, sw 5);
11b. every B7 instance against one `colband_torch` result (on the CPU,
    same inputs, in the pool of 3b) and the oracle on 100 seeded random
    buckets: bw 31-751
    (one to 24 row warps, rolling windows), Z-drop exits inside a group,
    N runs, empty slices, GB not a multiple of 8;
12. the headline through the engine with `EngineConfig(colband=True)`,
    the launch counts set to 0 just before the align and read just
    after: every bucket routed "colband", one B7 launch each, all of the
    engine's instance (`ops.colband.colband_rows`: R = 4 at RW 1536),
    all four fields of all 1024 pairs equal to the colband=False run;
    wall ms and GCUPS of both routes taken in turns (best of 3 each),
    per-bucket CUDA-event ms, a host-clock split of one align(); then
    the fewest-column bucket: every instance against one `colband_torch`
    result, B2 on the same bucket with its time, and for each instance
    its time, B2 / B7, the slope of `probes.colband_bench` (P1) in ns
    per column and its clock64 split of a column;
12b. the same set and checks at bw 255 (RW 544) and bw 1000 (RW 2032),
    where the engine takes the R = 2 and the R = 8 instance: each
    align's launches counted alone, all four fields equal to the
    colband=False run, and its fewest-column bucket's instances against
    `colband_torch`, the engine's instance against B2, both timed;
13. the cost probe (P2, on B7's layout): each instance (R = 2, 4, 8
    rows a thread) under each of the original's five switch sets against
    one `colband_probe_torch` result exactly (outputs and the final H, F
    and ring) at RW 384 with 128 pairs and 256 columns, then the seven
    timed variants of `probes.colband_probe` at `colband_rows`' R (RW
    1568 / 768 / 384, 1024 pairs, 2048 columns), the full variant and
    its four ablations at B7's headline window (RW 1536, R = 4, 128
    pairs), each in ns per column and as a share of the full variant,
    beside phase 12's clock64 split of B7 at that R and RW, and the full
    variant at full size against its plain version, with its bound;
14. the wave-interleave probe (P3; its instances' ptxas registers and
    spills are among phase 1's lines): each instance (1, 2, 4 waves) against `wave_probe_torch`
    exactly (outputs and the whole final state) on 64 ragged pairs over
    20 packed diagonals (the feed phase wraps), the original's five
    timed variants (G 32, 39 packed diagonals: its lines and ratio
    lines, then per-block ns per substep against the resident blocks,
    and GCUPS-equivalent), then the base
    variant at full size (4096 ragged pairs) against its plain version,
    with its bound and the contract's floor;
15. the skewed-frame probe (P4; ptxas lines as for P3): each instance
    at its full width (W 1024 / 896: 128 / 112
    threads) against `skew_probe_torch` exactly on 16 ragged pairs,
    the original's four timed variants at G 16 x 2400 packed diagonals
    (128 blocks, ragged 11-13 kb meta), `current`'s per-block ns per
    substep beside B2's ns per diagonal from phase 4, then all four at
    128 blocks and full width over 150 packed diagonals against their
    plain versions, with both times, the bound and the contract's floor;
16. the longest pair of the ONT workload (bw 2001, rlen past 65535)
    against the plain version, which a host process started before
    phase 0 runs on the CPU beside phases 0-15;
17. the command line (`agatha_tpu_torch.cli`) as a user runs it: each
    call a subprocess started in a temporary directory with the repo on
    PYTHONPATH.  The golden score.log / score2.log byte for byte (the
    four golden calls at once); `--cigar` equal for `--tb-mode` device
    and host; the headline set written by `scripts.make_dataset`, run in
    AGAThA.sh's order with `-p` and a raw.log, equal to an in-process
    `align` of the same FASTA (its launches counted), one raw.log line a
    bucket, `--stream -a 256` equal to batch, `scripts.avg_time`'s
    time.json the raw.log sum; 8192 x 150 bp `--stream --cigar -a 2048`
    equal to batch `--cigar`, every CIGAR rescored to its score and
    ends, an in-process `align_stream` of the same FASTA (its launches
    counted) equal to it with its peak allocated memory under two
    bitmaps + 1 GiB; one `{"cli_runs": [...]}` line with each call's
    process time, wall, lines and buckets or chunks;
18. `scripts.engine_stress` on the card: one seeded round of each of its
    three configs, one with colband, one with device traceback, every
    pair against the oracle (in a process pool);
19. the multi-device dispatch over pinned slots (two on card 0, or
    every card when there are several; `parallel.sharding`): (a)
    `align_bucket_sharded` on 13 headline pairs padded to the slots' row
    unit, one launch a slot, equal to `align_bucket` on one device; (b)
    the headline through the engine pinned to the slots, every route
    "anti-sharded" with one B2 launch a slot a bucket, all four fields
    equal to phase 4's, the single-device and sharded walls taken in
    turns; (c) 8192 x 150 bp through the colsweep round-robin and (d)
    the headline with colband through its round-robin, each equal to
    phase 7a's / 12's, and (e) the headline with CIGARs, each bucket
    split into at least one part a slot: a spy on the route's wrapper
    sees each bucket in turn on its slot's device with that device
    current; all four fields and the CIGARs equal phase 9's, every
    CIGAR rescored; each round-robin's wall taken in turns with one
    slot's; (f) two processes, each `AlignEngine(device="cuda")`,
    join a gloo group on 127.0.0.1 (`parallel.distributed.initialize`)
    and align their `host_shard` of the headline set; the merged fields
    equal phase 4's, with each process's align wall and process time.

Phase 1 also prints the resident blocks per SM of the four antidiagonal
instances at bw 751, 2001 and 3000.  Phases 2-3b, 4, 8-10 and 16 hold
the tile kernel (B1 / B2, and B3 with flags) against its plain version
and the oracle; B3's bitmaps are compared on computed cells, its walked
words and the engine's CIGARs whole.

Each kernel's bound is the larger of its bytes (inputs read once, the
output written once; for the chain, the ring rows each pair reads up to
its last live diagonal; for B3, the flag planes each pair swept; for
B6, one flag word per move) over 3.35 TB/s and its int32 operations on
this run's data over the int32 issue rate (132 SMs x 64 int32 lanes x
1.98 GHz, H100 SXM).  B7's bound is the one the antidiagonal kernel has
on the same bucket plus the chain: 12 operations per in-band cell of the
diagonals each pair swept and 15 per swept diagonal, so that the two
rows compare like with like; the probe's counts its placeholder masks'
cells and 15 per chain row; P3's and P4's count the C-true cells of
their masks (the plain version's mask functions) and 15 per live
pair-wave substep, on the inputs timed, and beside that bound phases 14
and 15 print the contract's floor on their lines: 12 operations a
lane-substep, since the contract runs every lane on every substep.

The last three lines are the card's `nvidia-smi` line, one JSON object
describing each kernel of the path (``launches_multi``: its launches in
phase 19's counted runs; "colband" is B7 as the engine launches it, and
"colband_r<R>" each instance on the colband path at whose band the
engine takes it, phase 12's or 12b's, with that align's launches, its
band, and its times and bound on that run's fewest-column bucket), and
{"ok": true, "device": ...}.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import io
import json
import multiprocessing
import os
import pickle
import re
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from agatha_tpu_torch import (
    AlignConfig,
    AlignEngine,
    align_one_sweep,
    banded_cells,
    make_workload,
)
from agatha_tpu_torch import EngineConfig
from agatha_tpu_torch import engine as engine_mod
from agatha_tpu_torch import cli
from agatha_tpu_torch.bench import device_line
from agatha_tpu_torch.io.fasta import iter_fasta_pairs, read_fasta_pairs
from agatha_tpu_torch.ops import _nvcc, kernel, walk
from agatha_tpu_torch.ops import colband as cb
from agatha_tpu_torch.ops import colsweep as cs
from agatha_tpu_torch.probes import (
    colband_bench,
    colband_probe,
    skew_probe,
    substep_probe,
    wave_probe,
)
from agatha_tpu_torch.probes.antidiag_cells import cuda_ms
from agatha_tpu_torch.scripts import engine_stress, make_dataset
from agatha_tpu_torch.probes.colsweep_cells import graph_ms, host_split
from agatha_tpu_torch.parallel.sharding import (
    align_bucket_sharded,
    make_pairs_mesh,
    pad_rows,
)
from agatha_tpu_torch.ops.kernel import (
    align_bucket,
    align_bucket_torch,
    build_bucket_arrays,
    window_width,
)

CANON = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=400, band_width=751)
ONT = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                  slice_width=3, z_threshold=400, band_width=2001)
# bands past 1023 rows: the largest register instance of the column sweep
# and its shared-memory instance (still int16-safe)
WIDE = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                   slice_width=3, z_threshold=400, band_width=1200)
BASES = np.array(list("ACGT"))
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations the DP recurrence needs per cell, at least:
# substitution score (a per-column 16-entry profile indexed by the
# target code: 2), temp (1), H (2 max), F (temp - goe, f - ge, max: 3),
# E (e - ge, max, temp - goe shared with F: 2), (H << 16) + r (one
# IMAD: 1), the diagonal max (1).
OPS_PER_CELL = 12
# the probes P3 / P4's contract floor: every lane runs every substep,
# whatever its mask (outside it H, E and F still move), so at least the
# recurrence's 12 operations a lane-substep
OPS_PER_LANE_SUBSTEP = OPS_PER_CELL
# per swept diagonal of the chain: gate (4), unpack (2), q end (1),
# best test (1), Z-drop tests and gap (7)
OPS_PER_DIAG = 15
# the traceback nibble per cell, beyond the recurrence: E > temp and
# F > max(temp, E) (2), the source select (1), the two open tests (2;
# e - ge and f - ge are the recurrence's), packing the nibble (2), the
# shift-or into the plane word (1)
OPS_PER_NIBBLE = 8
# per move of the walk: state and source tests (3), move select (2),
# cursor updates (2), shift-or into the word (1), lane and nibble
# extraction (2)
OPS_PER_MOVE = 10


def codes(s: str) -> np.ndarray:
    """ASCII -> 4-bit codes padded with N to a multiple of 8."""
    c = np.frombuffer(s.encode(), np.uint8) & 0xF
    pad = -len(c) % 8
    return np.concatenate([c, np.full(pad, 14, np.uint8)])


def random_seq(rng, n: int, n_frac: float = 0.0) -> str:
    s = BASES[rng.integers(0, 4, size=n)]
    if n_frac:
        s[rng.random(n) < n_frac] = "N"
    return "".join(s)


def mutate(rng, s: str, sub=0.1, indel=0.05) -> str:
    out = []
    for ch in s:
        r = rng.random()
        if r < indel:
            continue
        out.append(BASES[rng.integers(0, 4)] if r < indel + sub else ch)
        if rng.random() < indel:
            out.append(BASES[rng.integers(0, 4)])
    return "".join(out) or "A"


def pair(q: str, t: str):
    return codes(q), codes(t), len(q), len(t)


def mixed_pairs(rng, n, lo, hi):
    """Half homologous, half unrelated pairs with lengths in [lo, hi)."""
    out = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(lo, hi)), 0.01)
        t = (mutate(rng, q)[: hi - 1] if i % 2 == 0
             else random_seq(rng, int(rng.integers(lo, hi)), 0.01))
        out.append(pair(q, t))
    return out


def to_cuda(meta, tcodes, qfwd):
    return tuple(torch.from_numpy(a).cuda() for a in (meta, tcodes, qfwd))


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[{self.name}] {time.perf_counter() - self.t0:.2f} s",
                  flush=True)


def compare(name, bucket, cfg, *, force_strips=False) -> int:
    """Kernel vs plain version on the same CUDA tensors; returns max |err|."""
    args = to_cuda(*bucket)
    got = align_bucket(*args, cfg, force_strips=force_strips)
    t0 = time.perf_counter()
    ref = align_bucket_torch(*args, cfg, force_strips=force_strips)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = cuda_ms(
        lambda: align_bucket(*args, cfg, force_strips=force_strips), reps=3
    )
    err = int((got - ref).abs().max())
    w = 2 * bucket[1].shape[1]
    bound_ms, bound_by = antidiag_bound(bucket, got.cpu().numpy(), cfg)
    print(f"  {name}: GB={bucket[0].shape[0]} W={w} "
          f"windowed={w > window_width(cfg)} max_abs_err={err} "
          f"kernel {kernel_ms:.3f} ms plain {plain_ms:.3f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    if not torch.equal(got, ref):
        bad = (got != ref).any(dim=1).nonzero().flatten()[:5].tolist()
        raise AssertionError(
            f"{name}: kernel != plain version at rows {bad}: "
            f"{got[bad].tolist()} vs {ref[bad].tolist()}"
        )
    return err


def check_oracle(name, pairs, out, cfg) -> int:
    err = 0
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = np.asarray(align_one_sweep(qc, tc, ql, rl, cfg))
        got = np.asarray(out[p, :3])
        err = max(err, int(np.abs(got - exp).max()))
        if not (got == exp).all():
            raise AssertionError(
                f"{name}: pair {p} (ql={ql}, rl={rl}) kernel "
                f"{got.tolist()} oracle {exp.tolist()}"
            )
    print(f"  {name}: {len(pairs)} pairs equal the oracle")
    return err


def phase_card() -> str:
    smi = device_line()
    print(smi)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): bytes over HBM rate vs int32 ops over rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def antidiag_bound(bucket, out, cfg) -> tuple[float, str]:
    """Bound of the antidiagonal kernel on a bucket whose (GB, 4) output
    is `out`: the in-band cells of the diagonals each pair swept."""
    meta, tcodes, qfwd = bucket
    cells = banded_cells(meta[:, 0], meta[:, 1], out[:, 3], cfg.band_width)
    nbytes = meta.nbytes + tcodes.nbytes + qfwd.nbytes + out.nbytes
    return bound(nbytes, OPS_PER_CELL * cells)


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = (kernel.LIB, cs.LIB, walk.LIB, cb.LIB, substep_probe.LIB)
    _nvcc.build(*(lib.source for lib in libs))
    for lib in libs:
        lib.load()
    print(f"  nvcc + load (five sources, in parallel) "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in lib.log.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas {lib.source}:", line.split("'")[1])
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.source}:", line.strip())
    for label, cfg, wt in (("bw 751", CANON, 10240), ("bw 2001", ONT, 76800),
                           ("bw 3000", AlignConfig(band_width=3000), 8192)):
        occ = [kernel.occupancy(cfg, wt, safe16=s16, emit_flags=em)
               for s16 in (True, False) for em in (False, True)]
        print(f"  antidiag {label}: {kernel.tile_threads(cfg, wt)} threads "
              f"a block; resident blocks per SM, safe16 score / flags, "
              f"strips score / flags: {occ}")


def phase_kernel_vs_plain(rng) -> int:
    err = 0
    full = build_bucket_arrays(mixed_pairs(rng, 64, 50, 1017), CANON)
    err = max(err, compare("full-width canonical (safe16)", full, CANON))
    err = max(err, compare("full-width force_strips", full, CANON,
                           force_strips=True))
    zneg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                       z_threshold=-1, band_width=751)
    err = max(err, compare("z=-1 (strip path)", full, zneg))
    for bw, z in ((60, 200), (36, 150)):
        cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                          band_width=bw, z_threshold=z)
        b = build_bucket_arrays(mixed_pairs(rng, 16, 650, 1001), cfg)
        err = max(err, compare(f"windowed bw={bw}", b, cfg))
    asym = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                       band_width=50, z_threshold=-1)
    pairs = [pair(random_seq(rng, ql), random_seq(rng, rl))
             for ql, rl in ((100, 900), (900, 100), (1, 800), (700, 700))]
    err = max(err, compare("asymmetric (windowed)",
                           build_bucket_arrays(pairs, asym), asym))
    pairs = [pair("N" * 50, random_seq(rng, 60)),
             pair(random_seq(rng, 70), "N" * 40),
             pair("N" * 33, "N" * 33)]
    err = max(err, compare("all-N", build_bucket_arrays(pairs, CANON),
                           CANON))
    # 4 real pairs (one of them 1x1) padded with dummy 1x1 rows
    pairs = mixed_pairs(rng, 3, 1, 300) + [pair("A", "A")]
    err = max(err, compare("1x1 padding rows",
                           build_bucket_arrays(pairs, CANON), CANON))
    return err


def phase_oracle(rng) -> int:
    pairs = mixed_pairs(rng, 16, 200, 2001)
    out = align_bucket(*to_cuda(*build_bucket_arrays(pairs, CANON)), CANON)
    return check_oracle("200 bp - 2 kb, canonical", pairs, out.cpu().numpy(),
                        CANON)


# the random buckets' configs: slice widths 1-4, bw 36 / 50 / 60 / 751,
# z < 0, a second scoring config
RANDOM_CFGS = [
    AlignConfig(band_width=50, z_threshold=-1, slice_width=1),
    AlignConfig(band_width=60, z_threshold=200, slice_width=2),
    CANON,
    AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=4, z_threshold=30, band_width=60),
    AlignConfig(band_width=36, z_threshold=150),
]


def plain_pool():
    """Host processes, one thread each, for the plain versions that the
    random-bucket phases 3b and 11b compare the kernels with: each
    bucket's plain version runs there while this process launches the
    next buckets' kernels.  Two cores stay with this process and one
    with phase 16's plain version (`ont_pool`)."""
    workers = max(1, min(5, (os.cpu_count() or 3) - 3))
    return multiprocessing.get_context("spawn").Pool(
        workers, initializer=torch.set_num_threads, initargs=(1,))


def ont_pool():
    """One host process, one thread, for phase 16's plain version."""
    return multiprocessing.get_context("spawn").Pool(
        1, initializer=torch.set_num_threads, initargs=(1,))


def check_random_bucket(seed, bucket, cfg, strips, got, flagged):
    """Phase 3b's host half for one bucket (on a pool process): the plain
    version on the CPU against the kernel's (GB, 4) `got`, and with
    `flagged` = (planes, out, flags, b6) the flag kernel's results,
    swept planes (computed cells) and walked words against it, and B6's
    words against walk_torch.  Returns max |err|; raises on a mismatch."""
    host = tuple(torch.from_numpy(a) for a in bucket)
    got = torch.from_numpy(got)
    ref = align_bucket_torch(*host, cfg, force_strips=strips)
    if not torch.equal(got, ref):
        raise AssertionError(f"random bucket {seed}: kernel != plain")
    if flagged is not None:
        planes, out, flags, b6 = flagged
        out, flags, b6 = (torch.from_numpy(a) for a in (out, flags, b6))
        _r, ref_flags, mask = align_bucket_torch(
            *host, cfg, force_strips=strips, emit_flags=True,
            planes=planes, return_mask=True)
        vbases = torch.from_numpy(walk.vbase_schedule(
            planes, cfg, 2 * bucket[1].shape[1]))
        words = walk.walk_torch(flags, vbases, out)
        if not (torch.equal(out, ref) and swept_planes_equal(
                flags, ref_flags, out, planes, mask)
                and torch.equal(words,
                                walk.walk_torch(ref_flags, vbases, ref))):
            raise AssertionError(f"random bucket {seed}: flags != plain")
        if not torch.equal(b6, words):
            raise AssertionError(f"random bucket {seed}: B6 != walk_torch")
    return int((got - ref).abs().max())


def phase_random_buckets(pool, n: int = 200) -> int:
    """n seeded buckets of 1-8 pairs (a quarter of the small-band ones
    windowed, every third on the strip path, every seventh with an all-N
    and a 1-code pair): the kernel == the plain version in all four
    columns; every fifth also with flags (results, computed cells of the
    swept planes, words walked by walk_torch, and by B6 on the kernel's
    bitmap).  The plain versions run on the CPU on the same inputs, in
    `pool`'s processes (`check_random_bucket`): for buckets this small
    that is faster than their launches on the card."""
    kinds = {"windowed": 0, "strips": 0, "flags": 0}
    checks = []
    for seed in range(n):
        rng = np.random.default_rng(7000 + seed)
        cfg = RANDOM_CFGS[seed % len(RANDOM_CFGS)]
        windowed = seed % 4 == 0 and cfg.band_width < 100
        lo, hi = (400, 700) if windowed else (1, 260)
        pairs = mixed_pairs(rng, int(rng.integers(1, 9)), lo, hi)
        if seed % 7 == 0:
            pairs += [pair("N" * 33, random_seq(rng, 90)),
                      pair("C", random_seq(rng, 50))]
        strips = seed % 3 == 1
        bucket = build_bucket_arrays(pairs, cfg)
        args = to_cuda(*bucket)
        got = align_bucket(*args, cfg, force_strips=strips).cpu().numpy()
        kinds["windowed"] += 2 * bucket[1].shape[1] > window_width(cfg)
        kinds["strips"] += strips
        flagged = None
        if seed % 5 == 0:
            kinds["flags"] += 1
            planes = kernel.flag_planes_needed(bucket[0], cfg)
            out, flags = align_bucket(*args, cfg, force_strips=strips,
                                      emit_flags=True, planes=planes)
            vbases = torch.from_numpy(walk.vbase_schedule(
                planes, cfg, 2 * bucket[1].shape[1]))
            b6 = walk.walk(flags, vbases.cuda(), out)
            flagged = (planes, out.cpu().numpy(), flags.cpu().numpy(),
                       b6.cpu().numpy())
        checks.append(pool.apply_async(
            check_random_bucket, (seed, bucket, cfg, strips, got, flagged)))
    err = max(c.get() for c in checks)
    print(f"  {n} random buckets ({kinds['windowed']} windowed, "
          f"{kinds['strips']} on forced strips, {kinds['flags']} also with "
          "flags, walked by B6 too): kernel == plain version")
    return err


def ont_longest() -> tuple:
    """(index, pair) of the longest pair (the most diagonals) of the ONT
    workload (bench 128 75000 2001); its rlen is past 65535."""
    encoded = make_workload(128, 75000, seed=1234)
    i = max(range(len(encoded)), key=lambda i: encoded[i][2] + encoded[i][3])
    if encoded[i][3] <= 65535:
        raise AssertionError("the longest ONT pair does not pass 65535 rows")
    return i, encoded[i]


def ont_plain() -> tuple:
    """Phase 16's plain version, on a host process started before phase
    0 (its ~1.5 ms a diagonal on one core then overlaps phases 0-15):
    align_bucket_torch of the longest ONT pair's bucket on the CPU;
    ((GB, 4) output, ms)."""
    _i, p = ont_longest()
    host = tuple(torch.from_numpy(a)
                 for a in build_bucket_arrays([p], ONT))
    t0 = time.perf_counter()
    ref = align_bucket_torch(*host, ONT)
    return ref.numpy(), (time.perf_counter() - t0) * 1e3


def phase_ont_pair(job) -> int:
    """The kernel on the longest ONT pair against the plain version that
    `job` (`ont_plain`) computed on the same inputs."""
    i, p = ont_longest()
    bucket = build_bucket_arrays([p], ONT)
    args = to_cuda(*bucket)
    got = align_bucket(*args, ONT)
    kernel_ms = cuda_ms(lambda: align_bucket(*args, ONT), reps=3)
    got = got.cpu()
    ref, plain_ms = job.get()
    ref = torch.from_numpy(ref)
    err = int((got - ref).abs().max())
    bound_ms, bound_by = antidiag_bound(bucket, got.numpy(), ONT)
    print(f"  pair {i}, (qlen, rlen) {(p[2], p[3])}, {int(got[0, 3])} "
          f"diagonals swept: GB={bucket[0].shape[0]} "
          f"W={2 * bucket[1].shape[1]} max_abs_err={err} kernel "
          f"{kernel_ms:.3f} ms, plain version (CPU, one thread) "
          f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    if not torch.equal(got, ref):
        bad = (got != ref).any(dim=1).nonzero().flatten()[:5].tolist()
        raise AssertionError(f"ONT pair {i}: kernel != plain version at "
                             f"rows {bad}: {got[bad].tolist()} vs "
                             f"{ref[bad].tolist()}")
    return err


def phase_headline() -> dict:
    encoded = make_workload(1024, 10000, seed=1234)
    engine = AlignEngine(CANON, device="cuda")
    engine.align(encoded)  # warm-up

    _nvcc.launches.clear()
    res = engine.align(encoded)
    n_launches = _nvcc.launches["antidiag.score"]
    print(f"  one align(): {res.n_buckets} buckets, {n_launches} kernel "
          f"launches, routes {sorted(set(res.routes))}")
    if n_launches != res.n_buckets or n_launches == 0:
        raise AssertionError(f"{n_launches} launches for {res.n_buckets} "
                             "buckets")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        r = engine.align(encoded)
        best = min(best, time.perf_counter() - t0)
        for f in ("scores", "query_ends", "target_ends", "diags"):
            if not (getattr(r, f) == getattr(res, f)).all():
                raise AssertionError(f"{f} changed between runs")
    qlens = [e[2] for e in encoded]
    rlens = [e[3] for e in encoded]
    cells = banded_cells(qlens, rlens, res.diags, CANON.band_width)
    timed = engine.align(encoded, per_bucket_times=True)
    print(f"  wall {best * 1e3:.3f} ms  GCUPS {cells / best / 1e9:.4f}  "
          f"cells {cells}  buckets {res.n_buckets}")
    print("  bucket CUDA-event ms: "
          + " ".join(f"{m:.3f}" for m in timed.bucket_ms))
    print(f"  sum of bucket ms {sum(timed.bucket_ms):.3f}")

    shortest = np.argsort(np.asarray(qlens) + np.asarray(rlens))[:4]
    sub = [encoded[i] for i in shortest]
    out = np.stack([[res.scores[i], res.query_ends[i], res.target_ends[i]]
                    for i in shortest])
    err = check_oracle("4 shortest pairs", sub, out, CANON)

    buckets = list(engine.iter_buckets(encoded))
    b = min(buckets, key=lambda b: int(res.diags[b.indices].max()))
    args = to_cuda(b.meta, b.tcodes, b.qfwd)
    got = align_bucket(*args, CANON)
    t0 = time.perf_counter()
    ref = align_bucket_torch(*args, CANON)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(err, int((got - ref).abs().max()))
    if not torch.equal(got, ref):
        raise AssertionError("fewest-diagonal bucket: kernel != plain")
    kernel_ms = cuda_ms(lambda: align_bucket(*args, CANON), reps=5)
    bound_ms, bound_by = antidiag_bound((b.meta, b.tcodes, b.qfwd),
                                        got.cpu().numpy(), CANON)
    max_diags = int(res.diags[b.indices].max())
    print(f"  fewest-diagonal bucket: GB={b.meta.shape[0]} "
          f"W={2 * b.tcodes.shape[1]} max diags {max_diags}: kernel "
          f"{kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, equal; "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"launches": n_launches, "max_abs_err": err,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ns_per_diag": kernel_ms * 1e6 / max_diags,
            "res": res, "wall_ms": best * 1e3, "encoded": encoded}


def shapes_of(bucket, cfg):
    return cs.colsweep_shapes(bucket[0], bucket[1], bucket[2], cfg)


def compare_colsweep(name, bucket, cfg) -> int:
    """B4 / B5 kernels vs plain versions on the same CUDA tensors, ring
    and rows exactly, and the rows vs the antidiagonal kernel."""
    args = to_cuda(*bucket)
    meta = bucket[0]
    w, qf = 2 * bucket[1].shape[1], 2 * bucket[2].shape[1]
    if not cs.bucket_eligible(meta, w, qf, cfg):
        raise AssertionError(f"{name}: bucket is not colsweep-eligible")
    shapes = shapes_of(bucket, cfg)
    ring = cs.colsweep_sweep_cuda(*args, cfg, shapes)
    rows = cs.colsweep_chain_cuda(args[0], ring, cfg)
    ring_ref = cs.colsweep_sweep_torch(*args, cfg, shapes)
    rows_ref = cs.colsweep_chain_torch(args[0], ring_ref, cfg)
    anti = align_bucket(*args, cfg) if meta.shape[0] % 8 == 0 else rows_ref
    torch.cuda.synchronize()
    err = max(int((ring.to(torch.int64) - ring_ref).abs().max()),
              int((rows - rows_ref).abs().max()))
    k_rows = cs.sweep_rows(shapes[0])
    print(f"  {name}: GB={meta.shape[0]} (R, Q, d_pad)={shapes} sweep "
          f"{f'K={k_rows} registers' if k_rows else 'shared memory'} "
          f"max_abs_err={err}")
    if not torch.equal(ring, ring_ref):
        bad = (ring != ring_ref).any(dim=0).nonzero().flatten()[:5].tolist()
        raise AssertionError(f"{name}: sweep ring != plain at pairs {bad}")
    if not torch.equal(rows, rows_ref):
        bad = (rows != rows_ref).any(dim=1).nonzero().flatten()[:5].tolist()
        raise AssertionError(f"{name}: chain != plain at rows {bad}: "
                             f"{rows[bad].tolist()} vs "
                             f"{rows_ref[bad].tolist()}")
    if not torch.equal(rows, anti):
        raise AssertionError(f"{name}: colsweep != antidiagonal kernel")
    return err


def short_pairs(rng, n, lo, hi, cap=752):
    """Half homologous, half unrelated; both sides at most cap bp."""
    out = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(lo, hi)), 0.01)
        t = (mutate(rng, q) if i % 2 == 0
             else random_seq(rng, int(rng.integers(lo, hi)), 0.01))
        out.append(pair(q, t[:cap] or "A"))
    return out


# the column sweep's configs: the canonical one, a tight z and another
# scoring config and slice width
CS_CFGS = [
    CANON,
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3, z_threshold=20, band_width=751),
    AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=5, z_threshold=150, band_width=911),
]


def phase_colsweep_vs_plain(rng) -> int:
    _canon, tight, other = CS_CFGS
    err = 0
    for name, pairs, cfg in (
        ("150 bp", short_pairs(rng, 64, 140, 160), CANON),
        ("600 bp", short_pairs(rng, 32, 570, 630), CANON),
        ("740-752 bp (eligibility edge)", short_pairs(rng, 16, 740, 753),
         CANON),
        ("tight z=20", short_pairs(rng, 32, 8, 400), tight),
        ("m2 x3 q5 r1 s5 z150 w911", short_pairs(rng, 32, 8, 900, 904),
         other),
    ):
        err = max(err, compare_colsweep(name, build_bucket_arrays(pairs, cfg),
                                        cfg))
    pairs = [pair("N" * 50, random_seq(rng, 60)),
             pair(random_seq(rng, 70), "N" * 40),
             pair("N" * 33, "N" * 33)] + short_pairs(rng, 3, 1, 300) + \
        [pair("A", "A")]
    err = max(err, compare_colsweep(
        "all-N and 1x1 padding rows", build_bucket_arrays(pairs, CANON),
        CANON))
    meta, tcodes, qfwd = build_bucket_arrays(short_pairs(rng, 200, 100, 200),
                                             CANON)
    err = max(err, compare_colsweep(
        "GB=37 (not a multiple of 128)",
        (meta[:37].copy(), tcodes[:37].copy(), qfwd[:37].copy()), CANON))
    # past bw 751: the largest register instance (R = 1024, K = 32) and
    # the shared-memory one (R > 1024)
    smem_before = _nvcc.launches["colsweep.sweep.smem"]
    for name, lo, hi in (("the largest register instances, 900-1024 bp",
                          900, 1025),
                         ("shared memory, 1030-1120 bp", 1030, 1121)):
        pairs = short_pairs(rng, 24, lo, hi, cap=hi - 1)
        err = max(err, compare_colsweep(
            f"{name}, bw 1200", build_bucket_arrays(pairs, WIDE), WIDE))
    if _nvcc.launches["colsweep.sweep.smem"] != smem_before + 1:
        raise AssertionError("the shared-memory sweep instance did not run")
    return err


def boundary_pairs(rng, lengths):
    """Identical pairs: diagonal 2r has its max at row r, so every lane's
    last row holds the max of a diagonal that the next lane's first row
    merges into in the same step (a lost merge shows there)."""
    out = []
    for n in lengths:
        s = random_seq(rng, n)
        out.append(pair(s, s))
    return out


def check_boundary_maxima(name, ring, pairs, shapes) -> None:
    """The construction holds: each identical pair's diagonal 2r of a
    lane's last row r has its max at row r."""
    k = cs.sweep_rows(shapes[0])
    for p, (_qc, _tc, ql, rl) in enumerate(pairs):
        if ql != rl:
            continue
        rb = np.arange(k - 1, ql - 1, k)
        got = ring[2 * rb, p].cpu().numpy() & 0xFFFF
        if not (got == rb).all():
            raise AssertionError(f"{name}: pair {p} boundary rows {rb[:5]} "
                                 f"do not hold their diagonals' maxima")


def phase_colsweep_random(n: int = 200) -> int:
    """n seeded colsweep-eligible buckets (lengths 1-752, GB 1-600, three
    configs, N runs, every tenth with identical pairs whose lane-boundary
    rows hold their diagonals' maxima): B4's ring and B5's rows == the
    plain versions exactly (on the card, same tensors), and every eighth
    bucket's first two pairs == the oracle."""
    err, n_oracle, instances = 0, 0, set()
    for seed in range(n):
        rng = np.random.default_rng(8000 + seed)
        cfg = CS_CFGS[seed % len(CS_CFGS)]
        hi = int(rng.choice([24, 160, 400, 753]))
        gb = int(rng.integers(1, 601)) if seed % 3 else int(
            rng.integers(1, 40))
        if seed % 10 == 0:
            gb = max(gb, 3)  # room for the three identical pairs
        pairs = []
        for i in range(gb):
            q = random_seq(rng, int(rng.integers(1, hi)), 0.02)
            if i % 2:
                t = random_seq(rng, int(rng.integers(1, hi)), 0.02)
            else:
                t = mutate(rng, q)[:752] or "A"
            if seed % 5 == 0 and i % 7 == 3:
                q = "N" * int(rng.integers(1, 40)) + q[: hi - 41]
            pairs.append(pair(q, t))
        if seed % 10 == 0:
            pairs[:3] = boundary_pairs(rng, [int(rng.integers(hi // 2 + 1,
                                                              hi))] * 3)
        bucket = build_bucket_arrays(pairs, cfg)
        meta, tcodes, qfwd = (a[:gb].copy() for a in bucket)
        if not cs.bucket_eligible(meta, 2 * tcodes.shape[1],
                                  2 * qfwd.shape[1], cfg):
            raise AssertionError(f"random colsweep bucket {seed} is not "
                                 "eligible")
        args = to_cuda(meta, tcodes, qfwd)
        shapes = cs.colsweep_shapes(meta, tcodes, qfwd, cfg)
        instances.add(cs.sweep_rows(shapes[0]))
        ring = cs.colsweep_sweep_cuda(*args, cfg, shapes)
        rows = cs.colsweep_chain_cuda(args[0], ring, cfg)
        ring_ref = cs.colsweep_sweep_torch(*args, cfg, shapes)
        rows_ref = cs.colsweep_chain_torch(args[0], ring_ref, cfg)
        err = max(err, int((ring.to(torch.int64) - ring_ref).abs().max()),
                  int((rows - rows_ref).abs().max()))
        if not torch.equal(ring, ring_ref):
            bad = (ring != ring_ref).any(dim=0).nonzero().flatten()[:5]
            raise AssertionError(f"random colsweep bucket {seed}: ring != "
                                 f"plain at pairs {bad.tolist()}")
        if not torch.equal(rows, rows_ref):
            bad = (rows != rows_ref).any(dim=1).nonzero().flatten()[:5]
            raise AssertionError(f"random colsweep bucket {seed}: rows != "
                                 f"plain at pairs {bad.tolist()}")
        if seed % 10 == 0:
            check_boundary_maxima(f"random colsweep bucket {seed}", ring,
                                  pairs[:3], shapes)
        if seed % 8 == 0:
            got = rows[:2, :3].cpu().numpy()
            for p, (qc, tc, ql, rl) in enumerate(pairs[:2]):
                n_oracle += 1
                exp = np.asarray(align_one_sweep(qc, tc, ql, rl, cfg))
                if not (got[p] == exp).all():
                    raise AssertionError(
                        f"random colsweep bucket {seed}: pair {p} "
                        f"{got[p].tolist()} oracle {exp.tolist()}")
    print(f"  {n} random buckets (register instances K in "
          f"{sorted(instances)}, {n // 10} with lane-boundary maxima): "
          f"ring and rows == plain versions; {n_oracle} pairs == oracle")
    return err


def phase_colsweep_oracle(rng) -> int:
    pairs = short_pairs(rng, 16, 50, 753)
    meta, tcodes, qfwd = build_bucket_arrays(pairs, CANON)
    out = cs.align_bucket_colsweep(*to_cuda(meta, tcodes, qfwd), CANON)
    return check_oracle("50-752 bp, canonical", pairs, out.cpu().numpy(),
                        CANON)


def time_bucket(b, cfg) -> dict:
    """One bucket's B4 and B5 against their plain versions (host clock
    around one synchronised run), with bounds.  A kernel's ms is CUDA
    events over back-to-back launches, as for every other kernel, which
    include the host's launch cost where that exceeds the kernel's;
    graph_ms is its device time by CUDA-graph replay
    (`colsweep_cells.graph_ms`), which leaves that cost out."""
    args = to_cuda(b.meta, b.tcodes, b.qfwd)
    shapes = cs.colsweep_shapes(b.meta, b.tcodes, b.qfwd, cfg)
    ring = cs.colsweep_sweep_cuda(*args, cfg, shapes)
    rows = cs.colsweep_chain_cuda(args[0], ring, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring_ref = cs.colsweep_sweep_torch(*args, cfg, shapes)
    torch.cuda.synchronize()
    sweep_plain = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rows_ref = cs.colsweep_chain_torch(args[0], ring, cfg)
    torch.cuda.synchronize()
    chain_plain = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(ring, ring_ref) and torch.equal(rows, rows_ref)):
        raise AssertionError("timed bucket: kernel != plain version")
    def sweep():
        return cs.colsweep_sweep_cuda(*args, cfg, shapes)

    def chain():
        return cs.colsweep_chain_cuda(args[0], ring, cfg)

    sweep_ms, chain_ms = cuda_ms(sweep, reps=10), cuda_ms(chain, reps=10)
    sweep_graph, chain_graph = graph_ms(sweep), graph_ms(chain)
    gb = b.meta.shape[0]
    r8 = 8 * (-(-b.meta[:, 1].astype(np.int64) // 8))
    cells = int((r8 * b.meta[:, 0]).sum())
    ring_bytes = shapes[2] * gb * 4
    in_bytes = b.meta.nbytes + b.tcodes.nbytes + b.qfwd.nbytes
    sweep_bound = bound(in_bytes + ring_bytes, OPS_PER_CELL * cells)
    # the chain reads each pair's ring column up to its last live
    # diagonal (rows[:, 3] of them), then writes one row
    diags = int(rows[:, 3].sum())
    chain_bound = bound(b.meta.nbytes + 4 * diags + gb * 16,
                        OPS_PER_DIAG * diags)
    print(f"  one bucket: GB={gb} (R, Q, d_pad)={shapes} cells {cells} "
          f"diags {diags}")
    k_rows = cs.sweep_rows(shapes[0])
    print(f"    B4 sweep (K={k_rows}) {sweep_ms:.4f} ms events, graph "
          f"{sweep_graph:.4f} ms (plain {sweep_plain:.3f} ms, bound "
          f"{sweep_bound[0]:.4f} ms, {sweep_bound[1]})")
    print(f"    B5 chain {chain_ms:.4f} ms events, graph {chain_graph:.4f} ms "
          f"(plain {chain_plain:.3f} ms, bound {chain_bound[0]:.6f} ms, "
          f"{chain_bound[1]})")
    if gb % 8 == 0:
        # the antidiagonal kernel (B1, full width) on the same bucket
        anti = align_bucket(*args, cfg)
        if not torch.equal(anti, rows):
            raise AssertionError("timed bucket: colsweep != antidiag")
        anti_ms = cuda_ms(lambda: align_bucket(*args, cfg), reps=10)
        ab = antidiag_bound((b.meta, b.tcodes, b.qfwd),
                            anti.cpu().numpy(), cfg)
        print(f"    B1 antidiag on the same bucket (W="
              f"{2 * b.tcodes.shape[1]}) {anti_ms:.4f} ms, bound "
              f"{ab[0]:.4f} ms ({ab[1]}), equal")
    return {"sweep": {"ms": sweep_ms, "graph_ms": sweep_graph,
                      "plain_ms": sweep_plain, "bound_ms": sweep_bound[0],
                      "bound_by": sweep_bound[1]},
            "chain": {"ms": chain_ms, "graph_ms": chain_graph,
                      "plain_ms": chain_plain,
                      "bound_ms": chain_bound[0],
                      "bound_by": chain_bound[1]}}


def counts() -> tuple[int, ...]:
    """(B1/B2, B3, B4, B5, B6) launches since `_nvcc.launches.clear()`."""
    n = _nvcc.launches
    return (n["antidiag.score"], n["antidiag.flags"],
            _nvcc.launched("colsweep.sweep"), n["colsweep.chain"], n["walk"])


def rows_launched(prefix: str) -> dict[int, int]:
    """{R: launches of <prefix>.r<R>} of the instances launched since
    `_nvcc.launches.clear()`."""
    return {r: _nvcc.launches[f"{prefix}.r{r}"] for r in cb.COLBAND_ROWS
            if _nvcc.launches[f"{prefix}.r{r}"]}


def phase_short_reads(mean_len: int) -> dict:
    """8192 pairs of mean_len bp through the engine on the card."""
    encoded = make_workload(8192, mean_len, seed=1234, spread=0.05)
    engine = AlignEngine(CANON, device="cuda")
    engine.align(encoded)  # warm-up

    _nvcc.launches.clear()
    res = engine.align(encoded)
    counts = (_nvcc.launches["antidiag.score"],
              _nvcc.launched("colsweep.sweep"),
              _nvcc.launches["colsweep.chain"])
    print(f"  one align(): {res.n_buckets} buckets, routes "
          f"{sorted(set(res.routes))}, launches antidiag/sweep/chain "
          f"{counts} (shared-memory sweep "
          f"{_nvcc.launches['colsweep.sweep.smem']})")
    if res.routes != ["colsweep"] * res.n_buckets:
        raise AssertionError(f"routes {res.routes}")
    if counts != (0, res.n_buckets, res.n_buckets):
        raise AssertionError(f"launches {counts} for {res.n_buckets} "
                             "buckets")

    off = AlignEngine(CANON, EngineConfig(colsweep=False),
                      device="cuda").align(encoded)
    for f in ("scores", "query_ends", "target_ends", "diags"):
        if not (getattr(res, f) == getattr(off, f)).all():
            bad = np.nonzero(getattr(res, f) != getattr(off, f))[0][:5]
            raise AssertionError(f"{f} != colsweep=False run at {bad}")
    print(f"  all {len(encoded)} pairs equal the colsweep=False run "
          f"(routes {sorted(set(off.routes))}) in all four fields")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        r = engine.align(encoded)
        best = min(best, time.perf_counter() - t0)
        if not (r.scores == res.scores).all():
            raise AssertionError("scores changed between runs")
    cells = banded_cells([e[2] for e in encoded], [e[3] for e in encoded],
                         res.diags, CANON.band_width)
    timed = engine.align(encoded, per_bucket_times=True)
    print(f"  wall {best * 1e3:.3f} ms  reads/s {len(encoded) / best:.1f}  "
          f"GCUPS {cells / best / 1e9:.4f}  cells {cells}")
    print("  bucket CUDA-event ms (sweep + chain): "
          + " ".join(f"{m:.4f}" for m in timed.bucket_ms))
    print(f"  sum of bucket ms {sum(timed.bucket_ms):.4f}")
    split = host_split(engine, encoded)
    print("  host split of one align(), ms: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items()))
    err = check_oracle("8 pairs", encoded[:8], np.stack(
        [res.scores[:8], res.query_ends[:8], res.target_ends[:8]], 1), CANON)
    b = next(engine.iter_buckets(encoded))
    t = time_bucket(b, CANON)
    return {"launches_sweep": counts[1], "launches_chain": counts[2],
            "max_abs_err": err, "res": res, "encoded": encoded, **t}

# --- device traceback: B3 (flag-emitting antidiag) and B6 (walk) ---------


def swept_planes_equal(a, b, out, planes, mask) -> bool:
    """Two bitmaps agree on every computed cell (``mask``, the plain
    version's `return_mask`) of every plane before each pair's last
    swept one: the walk reads no other nibble, and the kernel writes no
    other (nor any plane past a pair's last diagonal)."""
    gb = a.shape[0]
    last = ((out[:, 3] - 1) >> 3).clamp(min=0)
    keep = torch.arange(planes, device=a.device)[None, :] < last[:, None]
    return torch.equal((a & mask).view(gb, planes, -1)[keep],
                       (b & mask).view(gb, planes, -1)[keep])


def tb_inputs(bucket, cfg):
    """CUDA tensors, plane count and vbases of a bucket's traceback."""
    meta, tcodes, qfwd = bucket
    planes = kernel.flag_planes_needed(meta, cfg)
    vbases = torch.from_numpy(
        walk.vbase_schedule(planes, cfg, 2 * tcodes.shape[1])).cuda()
    return to_cuda(meta, tcodes, qfwd), planes, vbases


def compare_traceback(name, bucket, cfg) -> int:
    """B3 vs its plain version (results, swept planes, walked words) and
    B6 vs walk_torch on the kernel's bitmap; returns max |err|."""
    args, planes, vbases = tb_inputs(bucket, cfg)
    out, flags = kernel.align_bucket(*args, cfg, emit_flags=True,
                                     planes=planes)
    ref, ref_flags, mask = kernel.align_bucket_torch(
        *args, cfg, emit_flags=True, planes=planes, return_mask=True)
    words = walk.walk(flags, vbases, out)
    words_plain = walk.walk_torch(flags, vbases, out)
    words_ref = walk.walk_torch(ref_flags, vbases, ref)
    torch.cuda.synchronize()
    err = max(int((out - ref).abs().max()),
              int((words.to(torch.int64) - words_ref).abs().max()))
    print(f"  {name}: GB={out.shape[0]} planes={planes} W_state="
          f"{flags.shape[1] // planes} max_abs_err={err} leading-gap "
          f"steps {int((words[:, planes // 2] != 0).sum())}")
    if not torch.equal(out, ref):
        raise AssertionError(f"{name}: B3 results != plain version")
    if not swept_planes_equal(flags, ref_flags, out, planes, mask):
        raise AssertionError(f"{name}: B3 flag planes != plain version "
                             "on computed cells")
    if not torch.equal(words_plain, words_ref):
        raise AssertionError(f"{name}: B3 walked words != plain version")
    if not torch.equal(words, words_plain):
        raise AssertionError(f"{name}: B6 words != walk_torch")
    return err


def phase_traceback_vs_plain(rng) -> int:
    err = 0
    s = random_seq(rng, 200)
    lead = [pair("T" * 10 + s, s), pair(s, "G" * 10 + s)]
    strips = AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                         slice_width=2, z_threshold=-1, band_width=751)
    bw60 = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                       band_width=60, z_threshold=200)
    asym = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                       band_width=50, z_threshold=-1)
    asym_pairs = [pair(random_seq(rng, ql), random_seq(rng, rl))
                  for ql, rl in ((100, 700), (700, 100), (1, 600),
                                 (640, 655), (20, 650), (650, 650))]
    padding = [pair("N" * 50, random_seq(rng, 60)),
               pair(random_seq(rng, 70), "N" * 40),
               pair("N" * 33, "N" * 33)] + mixed_pairs(rng, 3, 1, 300) + \
        [pair("A", "A")]
    for name, pairs, cfg in (
        ("full-width z400 + leading gaps", mixed_pairs(rng, 8, 250, 500)
         + lead, CANON),
        ("full-width z=-1 (strip path)", mixed_pairs(rng, 8, 250, 500),
         strips),
        ("windowed bw=60", mixed_pairs(rng, 8, 600, 900), bw60),
        ("asymmetric (windowed) bw=50", asym_pairs, asym),
        ("all-N and 1x1 padding rows", padding, CANON),
    ):
        err = max(err, compare_traceback(
            name, build_bucket_arrays(pairs, cfg), cfg))
    return err


def synthetic_bitmap(rng, gb: int, planes: int, w: int, shift: int):
    """A random flag bitmap on the card with its vbases and ends: nibble
    sources 0-2 (3, never written, one nibble in 500: a path that stops),
    vbases that rise by `shift` at most of the 8-plane boundaries, and
    cursors anywhere in the window, past its top lane, a few rows or
    columns from the origin (leading gaps) or past the last plane."""
    nib = rng.integers(0, 16, size=(gb, planes, w, 8), dtype=np.int64)
    src = nib & 3
    src = np.where((src == 3) & (rng.random(src.shape) > 0.002),
                   rng.integers(0, 3, size=src.shape), src)
    nib = (nib & 12) | src
    words = (nib << (4 * np.arange(8))).sum(axis=-1)
    flags = words.astype(np.uint32).view(np.int32).reshape(gb, planes * w)
    vbases = np.zeros(planes, np.int32)
    for h in range(3, -(-planes // 8)):
        vbases[8 * h:] += shift * (rng.random() < 0.7)
    ends = np.zeros((gb, 4), np.int32)
    for p in range(gb):
        d = int(rng.integers(8, 8 * planes))
        kind = p % 5
        if kind == 4:
            d = 8 * planes + int(rng.integers(0, 20))
        vb = int(vbases[min(d >> 3, planes - 1)])
        r = (int(rng.integers(0, 6)) if kind == 1
             else d - int(rng.integers(0, 6)) if kind == 2
             else vb + w + int(rng.integers(0, 12)) if kind == 3
             else vb + int(rng.integers(0, w)))
        r = min(max(r, 0), d)
        ends[p, 1:3] = d - r, r
    return (torch.from_numpy(flags).cuda(), torch.from_numpy(vbases).cuda(),
            torch.from_numpy(ends).cuda())


def phase_walk_random(n_real: int = 6, n_synth: int = 6) -> int:
    """B6 against walk_torch (run on the CPU on the same bitmap) at the
    headline's width: n_real seeded buckets of 1.1-2.2 kb pairs at bw 751
    (windowed, the window origin shifting), each with two pairs whose
    paths end in leading gaps, walked on B3's bitmap; then n_synth random
    bitmaps of 1024 lanes with vbase shifts of 128 and 8 rows."""
    err = 0
    shifts = steps = 0
    for seed in range(n_real + n_synth):
        rng = np.random.default_rng(8100 + seed)
        if seed < n_real:
            pairs = mixed_pairs(rng, int(rng.integers(2, 9)), 1100, 2200)
            s = random_seq(rng, int(rng.integers(1100, 1800)))
            k = int(rng.integers(1, 40))
            pairs += [pair("T" * k + s, s), pair(s, "G" * k + s)]
            bucket = build_bucket_arrays(pairs, CANON)
            if 2 * bucket[1].shape[1] <= window_width(CANON):
                raise AssertionError("the traceback bucket is not windowed")
            args, planes, vbases = tb_inputs(bucket, CANON)
            out, flags = kernel.align_bucket(*args, CANON, emit_flags=True,
                                             planes=planes)
        else:
            planes = int(rng.integers(200, 520))
            flags, vbases, out = synthetic_bitmap(
                rng, int(rng.integers(2, 9)), planes, window_width(CANON),
                (kernel.SHIFT_Q, 8)[seed % 2])
        words = walk.walk(flags, vbases, out)
        ref = walk.walk_torch(flags.cpu(), vbases.cpu(), out.cpu())
        err = max(err, int((words.cpu().to(torch.int64) - ref).abs().max()))
        if not torch.equal(words.cpu(), ref):
            bad = (words.cpu() != ref).any(dim=1).nonzero().flatten()[:5]
            raise AssertionError(f"random walk bucket {seed}: B6 != "
                                 f"walk_torch at rows {bad.tolist()}")
        shifts += len(set(vbases.tolist())) - 1
        row = (ref[:, planes >> 1] >> (16 * (planes & 1))) & 3
        steps += int((row != 0).sum())
    print(f"  {n_real} B3 bitmaps at bw 751 and {n_synth} random bitmaps "
          f"(W {window_width(CANON)}): B6 == walk_torch; {shifts} vbase "
          f"shifts, {steps} paths ending in a leading gap")
    if steps == 0 or shifts == 0:
        raise AssertionError("the random walk buckets miss leading gaps "
                             "or vbase shifts")
    return err


def cigar_scores(cigars, encoded, cfg):
    """Score and (query, target) bases consumed of each CIGAR, in NumPy
    per pair (M both, D target only, I query only; gap runs cost
    gap_oe + gap_extend * (n - 1))."""
    scores = np.zeros(len(cigars), np.int64)
    used = np.zeros((len(cigars), 2), np.int64)
    for i, (cig, (qc, tc, _ql, _rl)) in enumerate(zip(cigars, encoded)):
        runs = re.findall(r"(\d+)([MID])", cig)
        if not runs:
            continue
        n = np.array([int(k) for k, _ in runs])
        op = np.array(["MDI".index(o) for _, o in runs])
        col = np.repeat(op, n)
        qi = np.cumsum(col != 1) - 1
        ti = np.cumsum(col != 2) - 1
        m = col == 0
        qb = qc[qi[m]].astype(np.int64)
        tb = tc[ti[m]].astype(np.int64)
        sub = np.where(qb == tb, cfg.match, -cfg.mismatch)
        sub = np.where((qb == 14) | (tb == 14), -1, sub)
        gaps = n[op != 0]
        scores[i] = sub.sum() - (cfg.gap_oe * len(gaps)
                                 + cfg.gap_extend * (gaps - 1).sum())
        used[i] = (qi[-1] + 1, ti[-1] + 1)
    return scores, used


def check_cigars(name, res, encoded, cfg, host_cigars=None) -> None:
    """Every CIGAR rescores to its score and consumes the ends + 1; the
    host engine's CIGARs, where given, score the same."""
    scores, used = cigar_scores(res.cigars, encoded, cfg)
    empty = np.array([c == "" for c in res.cigars])
    ok = empty | ((scores == res.scores)
                  & (used[:, 0] == res.query_ends + 1)
                  & (used[:, 1] == res.target_ends + 1))
    if not ok.all():
        bad = np.nonzero(~ok)[0][:5]
        raise AssertionError(f"{name}: CIGARs of pairs {bad.tolist()} do "
                             "not rescore to the kernel's score and ends")
    if host_cigars is None:
        print(f"  all {len(encoded)} CIGARs rescore (vectorised) to their "
              f"scores and consume q_end + 1 / t_end + 1 "
              f"({int(empty.sum())} never-updated pairs get \"\")")
        return
    hscores, _ = cigar_scores(host_cigars, encoded, cfg)
    hempty = np.array([c == "" for c in host_cigars])
    if not ((hempty == empty).all() and (hscores == scores).all()):
        bad = np.nonzero((hscores != scores) | (hempty != empty))[0][:5]
        raise AssertionError(f"{name}: device and host CIGAR scores "
                             f"differ at pairs {bad.tolist()}")
    print(f"  all {len(encoded)} CIGARs rescore (vectorised) to their "
          f"scores and consume q_end + 1 / t_end + 1 ({int(empty.sum())} "
          "never-updated pairs get \"\"); CIGAR scores equal "
          "traceback_mode=\"host\"'s for every pair")


def time_tb_buckets(engine, encoded, cfg):
    """B3 and B6 CUDA-event ms of every traceback bucket, separately."""
    b3, b6, buckets = [], [], []
    for b in engine.iter_buckets(encoded, lane_kernels_ok=False):
        args, planes, vbases = tb_inputs((b.meta, b.tcodes, b.qfwd), cfg)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out, flags = kernel.align_bucket(*args, cfg, emit_flags=True,
                                         planes=planes)
        ev[1].record()
        walk.walk(flags, vbases, out)
        ev[2].record()
        torch.cuda.synchronize()
        b3.append(ev[0].elapsed_time(ev[1]))
        b6.append(ev[1].elapsed_time(ev[2]))
        buckets.append((b, planes))
        del flags
    return b3, b6, buckets


def words_moves(words: np.ndarray) -> int:
    """Non-zero 2-bit moves in a block of move words."""
    w = words.astype(np.uint32)
    m = (w | (w >> 1)) & np.uint32(0x55555555)
    return int(np.unpackbits(m.view(np.uint8)).sum())


def b3_bound(bucket, out, planes_swept, w_state, cfg):
    meta, tcodes, qfwd = bucket
    cells = banded_cells(meta[:, 0], meta[:, 1], out[:, 3], cfg.band_width)
    nbytes = (meta.nbytes + tcodes.nbytes + qfwd.nbytes + out.nbytes
              + 4 * w_state * planes_swept)
    return bound(nbytes, (OPS_PER_CELL + OPS_PER_NIBBLE) * cells)


def b6_bound(words: np.ndarray, planes: int):
    moves = words_moves(words)
    nbytes = 4 * moves + 16 * words.shape[0] + 4 * planes + words.nbytes
    return bound(nbytes, OPS_PER_MOVE * moves)


def traceback_run(name, encoded) -> dict:
    """One workload through align(traceback=True) on the card, checked
    against the score path, the CIGAR rescoring and host mode; walls,
    tb/score ratio, per-bucket B3/B6 ms and peak memory."""
    engine = AlignEngine(CANON, device="cuda")
    score = engine.align(encoded)  # warm-up, and the score-only result
    engine.align(encoded, traceback=True)  # warm-up

    _nvcc.launches.clear()
    res = engine.align(encoded, traceback=True)
    got = counts()
    n = res.n_buckets
    print(f"  one align(traceback=True): {n} buckets, routes "
          f"{sorted(set(res.routes))}, launches B1/B2, B3, B4, B5, B6 "
          f"{got}")
    if res.routes != ["walk"] * n or got != (0, n, 0, 0, n) or n == 0:
        raise AssertionError(f"routes {sorted(set(res.routes))}, launches "
                             f"{got} for {n} buckets")
    for f in ("scores", "query_ends", "target_ends", "diags"):
        if not (getattr(res, f) == getattr(score, f)).all():
            bad = np.nonzero(getattr(res, f) != getattr(score, f))[0][:5]
            raise AssertionError(f"{name}: {f} != score-only run at {bad}")
    print(f"  scores, ends and diagonals equal the score-only run")
    t0 = time.perf_counter()
    host = AlignEngine(CANON, EngineConfig(traceback_mode="host"),
                       device="cuda").align(encoded, traceback=True)
    host_ms = (time.perf_counter() - t0) * 1e3
    check_cigars(name, res, encoded, CANON, host.cigars)

    def wall(tb: bool) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = engine.align(encoded, traceback=tb)
        ms = (time.perf_counter() - t) * 1e3
        if not (r.scores == res.scores).all() or (tb and r.cigars
                                                  != res.cigars):
            raise AssertionError(f"{name}: results changed between runs")
        return ms

    before = [wall(False) for _ in range(2)]
    tb = [wall(True) for _ in range(3)]
    after = [wall(False) for _ in range(2)]
    score_ms = min(min(before), min(after))
    ratio = min(tb) / score_ms
    print("  walls ms: score before " + " ".join(f"{m:.3f}" for m in before)
          + ", traceback " + " ".join(f"{m:.3f}" for m in tb)
          + ", score after " + " ".join(f"{m:.3f}" for m in after))
    print(f"  traceback wall {min(tb):.3f} ms, score wall {score_ms:.3f} ms, "
          f"tb/score {ratio:.4f}; host mode (re-DP) wall {host_ms:.3f} ms")
    split = host_split(engine, encoded, traceback=True)
    print("  host split of one align(traceback=True), ms: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.align(encoded, traceback=True)
    peak = torch.cuda.max_memory_allocated()
    b3, b6, buckets = time_tb_buckets(engine, encoded, CANON)
    w_state = [min(2 * b.tcodes.shape[1], window_width(CANON))
               for b, _p in buckets]
    bitmaps = [b.meta.shape[0] * p * w * 4
               for (b, p), w in zip(buckets, w_state)]
    print(f"  peak allocated {peak / 2**30:.4f} GiB; largest bitmap "
          f"{max(bitmaps) / 2**30:.4f} GiB, all bitmaps "
          f"{sum(bitmaps) / 2**30:.4f} GiB")
    if peak > 2 * max(bitmaps) + 2**30:
        raise AssertionError(f"{name}: peak {peak} bytes exceeds two "
                             "bitmaps + 1 GiB")
    print("  B3 CUDA-event ms per bucket: "
          + " ".join(f"{m:.3f}" for m in b3) + f" (sum {sum(b3):.3f})")
    print("  B6 CUDA-event ms per bucket: "
          + " ".join(f"{m:.4f}" for m in b6) + f" (sum {sum(b6):.4f})")
    return {"launches": n, "wall_ms": min(tb), "score_ms": score_ms,
            "ratio": ratio, "peak": peak, "engine": engine,
            "buckets": buckets, "res": res}


def time_tb_bucket(name, b) -> dict:
    """B3 and B6 on one traceback bucket against their plain versions,
    with CUDA-event ms and bounds."""
    args, planes, vbases = tb_inputs((b.meta, b.tcodes, b.qfwd), CANON)
    out, flags = kernel.align_bucket(*args, CANON, emit_flags=True,
                                     planes=planes)
    words = walk.walk(flags, vbases, out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_flags, mask = kernel.align_bucket_torch(
        *args, CANON, emit_flags=True, planes=planes, return_mask=True)
    torch.cuda.synchronize()
    b3_plain = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    words_ref = walk.walk_torch(flags, vbases, out)
    torch.cuda.synchronize()
    b6_plain = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(out, ref)
            and swept_planes_equal(flags, ref_flags, out, planes, mask)):
        raise AssertionError("headline bucket: B3 != plain version")
    if not torch.equal(words, words_ref):
        raise AssertionError("headline bucket: B6 != walk_torch")
    words_plain = walk.walk_torch(ref_flags, vbases, ref)
    if not torch.equal(words, words_plain):
        raise AssertionError("headline bucket: B3's walked words != the "
                             "plain version's")
    del ref_flags, mask
    err = max(int((out - ref).abs().max()),
              int((words.to(torch.int64) - words_ref).abs().max()))
    b3_ms = cuda_ms(lambda: kernel.align_bucket(
        *args, CANON, emit_flags=True, planes=planes), reps=3)
    b6_ms = cuda_ms(lambda: walk.walk(flags, vbases, out), reps=5)
    b2_ms = cuda_ms(lambda: kernel.align_bucket(*args, CANON), reps=3)
    o = out.cpu().numpy()
    w_state = flags.shape[1] // planes
    swept = int(((o[:, 3].astype(np.int64) + 7) // 8).sum())
    bb3 = b3_bound((b.meta, b.tcodes, b.qfwd), o, swept, w_state, CANON)
    bb6 = b6_bound(words.cpu().numpy(), planes)
    print(f"  {name} bucket: "
          f"GB={b.meta.shape[0]} W={2 * b.tcodes.shape[1]} planes={planes} "
          f"max diags {int(o[:, 3].max())}")
    print(f"    B3 {b3_ms:.3f} ms (B2 score-only on the same bucket "
          f"{b2_ms:.3f} ms, ratio {b3_ms / b2_ms:.4f}); plain "
          f"{b3_plain:.3f} ms; bound {bb3[0]:.4f} ms ({bb3[1]}); equal")
    print(f"    B6 {b6_ms:.4f} ms; walk_torch {b6_plain:.3f} ms; bound "
          f"{bb6[0]:.6f} ms ({bb6[1]}, {words_moves(words.cpu().numpy())} "
          "moves); equal")
    return {"b3": {"ms": b3_ms, "plain_ms": b3_plain, "bound_ms": bb3[0],
                   "bound_by": bb3[1]},
            "b6": {"ms": b6_ms, "plain_ms": b6_plain, "bound_ms": bb6[0],
                   "bound_by": bb6[1]},
            "max_abs_err": err}


def phase_headline_traceback(encoded) -> dict:
    """encoded: the headline set of phase 4."""
    run = traceback_run("headline", encoded)
    res = run["res"]
    b, _planes = min(run["buckets"],
                     key=lambda bp: int(res.diags[bp[0].indices].max()))
    return {**run, **time_tb_bucket("fewest-diagonal", b)}


def phase_short_traceback() -> dict:
    encoded = make_workload(8192, 150, seed=1234, spread=0.05)
    run = traceback_run("150 bp", encoded)
    b, _planes = run["buckets"][0]
    return {**run, **time_tb_bucket("first", b)}


# --- the banded column sweep: B7, its harness P1 and its probe P2 --------


def colband_inputs(bucket, cfg):
    """CUDA tensors (scalars, tcodes, qfwd) and shapes of a bucket."""
    meta, tcodes, qfwd = bucket
    shapes = cb.colband_shapes(meta, cfg)
    scalars = torch.from_numpy(cb.chain_scalars(meta, cfg)).cuda()
    return (scalars, torch.from_numpy(tcodes).cuda(),
            torch.from_numpy(qfwd).cuda()), shapes


def colband_bound(bucket, out, cfg) -> tuple[float, str]:
    """The antidiagonal kernel's bound on the bucket plus the chain: the
    in-band cells of the diagonals each pair swept, and those diagonals."""
    meta, tcodes, qfwd = bucket
    cells = banded_cells(meta[:, 0], meta[:, 1], out[:, 3], cfg.band_width)
    nbytes = 32 * meta.shape[0] + tcodes.nbytes + qfwd.nbytes + out.nbytes
    return bound(nbytes, OPS_PER_CELL * cells
                 + OPS_PER_DIAG * int(out[:, 3].astype(np.int64).sum()))


def colband_all(args, cfg, shapes) -> dict:
    """Every B7 instance that takes the bucket's window, launched on the
    same CUDA tensors: {rows a thread: (GB, 4) output}."""
    return {r: cb.colband_cuda(*args, cfg, shapes, rows=r)
            for r in colband_bench.instances(shapes[0])}


def expect_instances(name, gots: dict, ref) -> int:
    """Every instance's output equals `ref` (on its device); returns the
    largest absolute difference."""
    err = 0
    for rows, got in gots.items():
        got = got.to(ref.device)
        err = max(err, int((got - ref).abs().max()) if got.numel() else 0)
        if not torch.equal(got, ref):
            bad = (got != ref).any(dim=1).nonzero().flatten()[:5].tolist()
            raise AssertionError(
                f"{name}: B7 R={rows} != colband_torch at rows {bad}: "
                f"{got[bad].tolist()} vs {ref[bad].tolist()}")
    return err


def compare_colband(name, pairs, bucket, cfg) -> int:
    """Every B7 instance vs colband_torch on the same CUDA tensors, then
    the engine's instance vs the antidiagonal kernel (all four columns)
    and the oracle."""
    args, shapes = colband_inputs(bucket, cfg)
    gots = colband_all(args, cfg, shapes)
    got = gots[cb.colband_rows(shapes[0])]
    ref = cb.colband_torch(*args, cfg, shapes)
    torch.cuda.synchronize()
    err = expect_instances(name, gots, ref)
    gb = bucket[0].shape[0]
    print(f"  {name}: GB={gb} (RW, R8pad, Qpad)={shapes[:3]} groups "
          f"gA={shapes[4]} gB={shapes[5]}, instances R = {sorted(gots)} "
          f"== colband_torch, max_abs_err={err}")
    if gb % 8 == 0:
        anti = align_bucket(*to_cuda(*bucket), cfg)
        if not torch.equal(got, anti):
            bad = (got != anti).any(dim=1).nonzero().flatten()[:5].tolist()
            raise AssertionError(f"{name}: B7 != antidiagonal kernel at "
                                 f"rows {bad}")
    return max(err, check_oracle(name, pairs, got.cpu().numpy(), cfg))


def phase_colband_vs_plain(rng) -> int:
    def cfg_of(bw, z=400, **kw):
        base = dict(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3)
        base.update(kw)
        return AlignConfig(z_threshold=z, band_width=bw, **base)

    shapes = [(16, 600), (600, 16), (200, 200), (64, 257), (1, 100),
              (100, 1), (300, 33), (33, 300)]
    other = cfg_of(55, 150, match=2, mismatch=3, gap_open=5, gap_extend=1,
                   slice_width=5)
    err = 0
    for name, pairs, cfg in (
        ("bw 63, 24 mixed pairs 8-300 bp", mixed_pairs(rng, 24, 8, 300),
         cfg_of(63)),
        ("bw 31 z 20, empty-slice shapes",
         [pair(random_seq(rng, ql, 0.05), random_seq(rng, rl, 0.05))
          for ql, rl in shapes], cfg_of(31, 20)),
        ("bw 751, 400-3000 bp (the window rolls)",
         mixed_pairs(rng, 16, 400, 3000), CANON),
        ("m2 x3 q5 r1 s5 z150 w55", mixed_pairs(rng, 16, 8, 500), other),
        ("all-N and 1x1 padding rows",
         [pair("N" * 50, random_seq(rng, 60)),
          pair(random_seq(rng, 70), "N" * 40), pair("N" * 33, "N" * 33)]
         + mixed_pairs(rng, 3, 1, 300) + [pair("A", "A")], cfg_of(63)),
    ):
        err = max(err, compare_colband(
            name, pairs, build_bucket_arrays(pairs, cfg), cfg))
    pairs = mixed_pairs(rng, 40, 8, 300)
    meta, tcodes, qfwd = build_bucket_arrays(pairs, cfg_of(63))
    err = max(err, compare_colband(
        "GB=37 (not a multiple of 8 or 128)", pairs[:37],
        (meta[:37].copy(), tcodes[:37].copy(), qfwd[:37].copy()),
        cfg_of(63)))
    return err


def colband_cfg(bw, z=400, **kw) -> AlignConfig:
    base = dict(match=1, mismatch=4, gap_open=6, gap_extend=2,
                slice_width=3)
    base.update(kw)
    return AlignConfig(z_threshold=z, band_width=bw, **base)


# the random colband buckets' configs: bw 31-751, slice widths 1-5, z < 0
# and tight Z-drops, three scoring configs
COLBAND_RANDOM_CFGS = [
    colband_cfg(31, 20), colband_cfg(63), colband_cfg(101, 20),
    colband_cfg(127, 800, match=3, mismatch=5, gap_open=4, slice_width=4),
    colband_cfg(55, 150, match=2, mismatch=3, gap_open=5, gap_extend=1,
                slice_width=5),
    colband_cfg(255, 60, slice_width=1), colband_cfg(180, -1, slice_width=2),
    colband_cfg(400, 30), colband_cfg(751),
]


def check_random_colband(seed, bucket, pairs, cfg, shapes, gots):
    """Phase 11b's host half for one bucket (on a pool process): every
    instance's (GB, 4) output in `gots` against one colband_torch result
    on the CPU, and the engine's instance against the oracle.  Returns
    max |err|; raises on a mismatch."""
    ref = cb.colband_torch(torch.from_numpy(cb.chain_scalars(bucket[0], cfg)),
                           torch.from_numpy(bucket[1]),
                           torch.from_numpy(bucket[2]), cfg, shapes)
    gots = {r: torch.from_numpy(g) for r, g in gots.items()}
    err = expect_instances(
        f"random colband bucket {seed} (bw {cfg.band_width})", gots, ref)
    got = gots[cb.colband_rows(shapes[0])]
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        exp = tuple(int(x) for x in align_one_sweep(qc, tc, ql, rl, cfg))
        if tuple(got[p, :3].tolist()) != exp:
            raise AssertionError(f"random colband bucket {seed}: pair "
                                 f"{p} B7 {got[p].tolist()} oracle {exp}")
    return err


def phase_colband_random(pool, n: int = 100) -> int:
    """Every B7 instance against one colband_torch result (run on the CPU
    on the same inputs, in `pool`'s processes: `check_random_colband`)
    and the engine's instance against the oracle on n seeded
    colband-eligible buckets: bw 31-751 (one to 24 row warps; the window
    rolls past its first groups), homologous prefixes with unrelated
    tails under tight Z-drops (the sweep stops inside a group), N runs,
    extreme aspect ratios (empty slices), and GB not a multiple of 8."""
    n_inst = 0
    kinds = {"rolling": 0, "zdrop": 0, "warps>1": 0}
    checks = []
    for seed in range(n):
        rng = np.random.default_rng(11000 + seed)
        cfg = COLBAND_RANDOM_CFGS[seed % len(COLBAND_RANDOM_CFGS)]
        bw = cfg.band_width
        if bw >= 400:
            pairs = mixed_pairs(rng, 2, 1000, 1700)
        elif seed % 5 == 1:
            pairs = []
            for _ in range(int(rng.integers(1, 5))):
                h = random_seq(rng, int(rng.integers(50, 250)))
                pairs.append(pair(h + random_seq(rng, int(rng.integers(
                    50, 300))), h + random_seq(rng, int(rng.integers(
                        50, 300)))))
        elif seed % 6 == 2:
            pairs = [pair(random_seq(rng, ql, 0.05), random_seq(rng, rl, 0.05))
                     for ql, rl in ((16, 500), (500, 16), (1, 90), (90, 1),
                                    (300, 33), (33, 300))[:int(
                                        rng.integers(2, 7))]]
        else:
            pairs = mixed_pairs(rng, int(rng.integers(1, 9)), 8,
                                int(rng.choice([200, 500, 900])))
        if seed % 7 == 0:
            q = random_seq(rng, 120) + "N" * 30 + random_seq(rng, 90)
            pairs.append(pair(q, mutate(rng, q)))
        meta, tcodes, qfwd = build_bucket_arrays(pairs, cfg)
        m = len(pairs)  # the wire's padding rows cut off: GB = m
        bucket = (meta[:m].copy(), tcodes[:m].copy(), qfwd[:m].copy())
        args, shapes = colband_inputs(bucket, cfg)
        gots = {r: g.cpu().numpy()
                for r, g in colband_all(args, cfg, shapes).items()}
        n_inst += len(gots)
        got = gots[cb.colband_rows(shapes[0])]
        kinds["rolling"] += shapes[5] > shapes[4]
        kinds["zdrop"] += int((got[:, 3] < cb.chain_scalars(
            bucket[0], cfg)[4]).sum() > 0)
        kinds["warps>1"] += shapes[0] > 256
        checks.append(pool.apply_async(
            check_random_colband, (seed, bucket, pairs, cfg, shapes, gots)))
    err = max(c.get() for c in checks)
    print(f"  {n} random buckets ({kinds['rolling']} with a rolling "
          f"window, {kinds['warps>1']} of several row warps, "
          f"{kinds['zdrop']} stopped by a Z-drop before the end cap): "
          f"every B7 instance ({n_inst} launches) == colband_torch == the "
          "oracle")
    if min(kinds.values()) == 0:
        raise AssertionError(f"the random colband buckets miss a kind: "
                             f"{kinds}")
    return err


def best_walls(engines, encoded, ref, reps=3, **kw) -> list[float]:
    """Best wall (s) of align(**kw) for each engine, taken in turns."""
    best = [float("inf")] * len(engines)
    for _ in range(reps):
        for i, engine in enumerate(engines):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = engine.align(encoded, **kw)
            best[i] = min(best[i], time.perf_counter() - t0)
            if not (r.scores == ref.scores).all():
                raise AssertionError("scores changed between runs")
    return best


def counted_colband_align(encoded, cfg) -> dict:
    """One align of `encoded` with `EngineConfig(colband=True)` at `cfg`,
    the launch counts set to 0 just before it and read just after: every
    bucket routed "colband", one B7 launch each, all of the instance
    `ops.colband.colband_rows` takes, and all four fields equal to the
    colband=False run."""
    on = AlignEngine(cfg, EngineConfig(colband=True), device="cuda")
    off = AlignEngine(cfg, device="cuda")
    on.align(encoded)  # warm-up
    ref = off.align(encoded)

    _nvcc.launches.clear()
    res = on.align(encoded)
    n_launches = _nvcc.launched("colband")
    n_anti = _nvcc.launches["antidiag.score"]
    by_rows = rows_launched("colband")
    buckets = list(on.iter_buckets(encoded))
    RW = cb.colband_shapes(buckets[0].meta, cfg)[0]
    chosen = cb.colband_rows(RW)
    print(f"  one align(colband=True) at bw {cfg.band_width}: "
          f"{res.n_buckets} buckets of "
          f"{sorted({b.meta.shape[0] for b in buckets})} pairs, RW {RW}, "
          f"routes {sorted(set(res.routes))}, launches B7 / B1-B2 "
          f"{n_launches} / {n_anti}, by rows a thread {by_rows} (the "
          f"engine's instance: R={chosen})")
    if (res.routes != ["colband"] * res.n_buckets or n_anti != 0
            or n_launches != res.n_buckets or n_launches == 0
            or by_rows != {chosen: n_launches}):
        raise AssertionError(f"routes {res.routes}, {n_launches} B7 "
                             f"({by_rows}) and {n_anti} antidiagonal "
                             "launches")
    for f in FIELDS:
        if not (getattr(res, f) == getattr(ref, f)).all():
            bad = np.nonzero(getattr(res, f) != getattr(ref, f))[0][:5]
            raise AssertionError(f"bw {cfg.band_width}: {f} != "
                                 f"colband=False run at {bad}")
    print(f"  all {len(encoded)} pairs equal the colband=False run (routes "
          f"{sorted(set(ref.routes))}, {ref.n_buckets} buckets) in all four "
          "fields")
    return {"on": on, "off": off, "ref": ref, "res": res,
            "buckets": buckets, "RW": RW, "rows": chosen,
            "launches": n_launches}


def fewest_column_bucket(run: dict, cfg) -> dict:
    """The fewest-column bucket of a `counted_colband_align` run: every
    instance against one `colband_torch` result on the card (both
    timed), the engine's instance against B2 (timed), and the bound."""
    b = min(run["buckets"], key=lambda b: int(b.meta[:, 0].max()))
    bucket = (b.meta, b.tcodes, b.qfwd)
    args, shapes = colband_inputs(bucket, cfg)
    gots = colband_all(args, cfg, shapes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = cb.colband_torch(*args, cfg, shapes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = expect_instances(f"fewest-column bucket at bw {cfg.band_width}",
                           gots, plain)
    anti_args = to_cuda(*bucket)
    anti = align_bucket(*anti_args, cfg)
    if not torch.equal(gots[run["rows"]], anti):
        raise AssertionError(f"fewest-column bucket at bw "
                             f"{cfg.band_width}: B7 != B2")
    anti_ms = cuda_ms(lambda: align_bucket(*anti_args, cfg), reps=3)
    bound_ms, bound_by = colband_bound(bucket, plain.cpu().numpy(), cfg)
    rows = run["rows"]
    ms = cuda_ms(lambda: cb.colband_cuda(*args, cfg, shapes, rows=rows),
                 reps=10)
    print(f"  fewest-column bucket: GB={b.meta.shape[0]} (RW, R8pad, Qpad)="
          f"{shapes[:3]} longest query {int(b.meta[:, 0].max())}: "
          f"instances R = {sorted(gots)} == colband_torch "
          f"({plain_ms:.3f} ms); B7 R={rows} {ms:.3f} ms, B2 "
          f"{anti_ms:.3f} ms, equal (B2 / B7 {anti_ms / ms:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"bucket": bucket, "args": args, "shapes": shapes,
            "instances": sorted(gots), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "anti_ms": anti_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_headline_colband(encoded) -> dict:
    """encoded: the headline set of phase 4."""
    run = counted_colband_align(encoded, CANON)
    on, off, ref, res = run["on"], run["off"], run["ref"], run["res"]
    wall_on, wall_off = best_walls((on, off), encoded, ref)
    cells = banded_cells([e[2] for e in encoded], [e[3] for e in encoded],
                         res.diags, CANON.band_width)
    print(f"  colband wall {wall_on * 1e3:.3f} ms  GCUPS "
          f"{cells / wall_on / 1e9:.4f}; antidiagonal wall in the same "
          f"phase {wall_off * 1e3:.3f} ms  GCUPS "
          f"{cells / wall_off / 1e9:.4f}; ratio {wall_off / wall_on:.4f}")
    timed = on.align(encoded, per_bucket_times=True)
    print("  bucket CUDA-event ms (B7): "
          + " ".join(f"{m:.3f}" for m in timed.bucket_ms)
          + f" (sum {sum(timed.bucket_ms):.3f})")
    split = host_split(on, encoded)
    print("  host split of one align(colband=True), ms: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items()))

    few = fewest_column_bucket(run, CANON)
    args, shapes, bucket = few["args"], few["shapes"], few["bucket"]
    instances = {}
    for rows in few["instances"]:
        ms = cuda_ms(lambda: cb.colband_cuda(*args, CANON, shapes, rows=rows),
                     reps=10)
        slope = colband_bench.bench_bucket(*bucket, CANON, reps=8, rounds=3,
                                           rows=rows)
        print(f"  B7 R={rows}: {ms:.3f} ms, equal to colband_torch; B2 / B7 "
              f"{few['anti_ms'] / ms:.4f}; P1 slope {slope['ms']:.4f} ms per "
              f"launch, {slope['ns_per_col']:.3f} ns per column "
              f"({slope['cols']} columns)")
        split = colband_bench.column_split(*bucket, CANON, rows)
        colband_bench.print_split(split)
        instances[rows] = {"ms": ms, "p1_ns_per_col": slope["ns_per_col"],
                           "split": split, "RW": shapes[0]}
    return {"launches": run["launches"], "rows": run["rows"],
            "band": CANON.band_width, "max_abs_err": few["max_abs_err"],
            "ms": few["ms"], "plain_ms": few["plain_ms"],
            "bound_ms": few["bound_ms"], "bound_by": few["bound_by"],
            "res": res, "instances": instances}


# bands of the headline set at which `colband_rows` takes the other
# instances: RW 544 (R = 2) and RW 2032 (R = 8)
OTHER_BANDS = (255, 1000)


def phase_colband_bands(encoded) -> dict:
    """The headline set through the colband route at each of
    OTHER_BANDS, counted as phase 12's run; {R: that run's launches and
    its fewest-column bucket's times}."""
    out = {}
    for bw in OTHER_BANDS:
        cfg = colband_cfg(bw)
        run = counted_colband_align(encoded, cfg)
        few = fewest_column_bucket(run, cfg)
        out[run["rows"]] = {
            "launches": run["launches"], "rows": run["rows"], "band": bw,
            **{k: few[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}}
    return out


def probe_bound(n: int, RW: int, ncols: int, with_chain: bool):
    """The probe's bound: 12 operations per cell inside its placeholder
    mask, 15 per chain row, and its three small arrays."""
    j = np.arange(ncols)
    w0 = 8 * (j // 8)
    lo = np.maximum(j - colband_probe.BW - w0 + (j & 7), 0)
    hi = np.minimum(j + colband_probe.BW - w0 - (j & 3), RW - 1)
    cells = int(np.maximum(hi - lo + 1, 0).sum()) * n
    rows = 2 * ncols * n if with_chain else 0
    return bound(4 * n * (2 + 4 + 4), OPS_PER_CELL * cells
                 + OPS_PER_DIAG * rows)


def phase_probe(b7_instances: dict) -> dict:
    """P2: every instance against one plain result per switch set, the
    seven timed variants, the ablation set at B7's headline window beside
    phase 12's split of B7 there (b7_instances: phase 12's instances),
    and the full variant at full size against its plain version."""
    err = 0
    ncols = 256
    meta, prev = colband_probe.probe_inputs(1, ncols, "cuda")
    meta[0, 1::3] = ncols - 13   # ragged column counts
    meta[0, 2::3] = 40
    prev = prev + torch.arange(4, dtype=torch.int32, device="cuda")[:, None]
    for name, _RW, switches in colband_probe.VARIANTS[:5]:
        ref, ref_state = colband_probe.colband_probe_torch(
            meta, prev, 384, ncols, return_state=True, **switches)
        for rows in cb.COLBAND_ROWS:
            before = _nvcc.launches[f"probe.colband.r{rows}"]
            got, state = colband_probe.colband_probe_cuda(
                meta, prev, 384, ncols, return_state=True, rows=rows,
                **switches)
            if _nvcc.launches[f"probe.colband.r{rows}"] != before + 1:
                raise AssertionError(f"probe {name}: no R={rows} launch")
            e = max(int((got - ref).abs().max()),
                    int((state.to(torch.int64) - ref_state).abs().max()))
            err = max(err, e)
            print(f"  {name}: R={rows} RW=384 pairs=128 columns={ncols} "
                  f"max_abs_err={e} (outputs, final H, F and ring)")
            if not (torch.equal(got, ref) and torch.equal(state, ref_state)):
                raise AssertionError(f"probe {name}, R={rows}: instance != "
                                     "plain version")

    G, ncols = 8, 2048
    _nvcc.launches.clear()
    ns = {}
    for variants, g in ((colband_probe.VARIANTS, G),
                        (colband_probe.ABLATIONS, colband_probe.ABLATION_G)):
        part = {name: colband_probe.run_variant(name, RW, g, ncols, rounds=3,
                                                **switches)[0]
                for name, RW, switches in variants}
        full = part[variants[0][0]]
        for name, RW, _switches in variants:
            print(f"    {name}: RW {RW} (R={colband_probe.probe_rows(RW)}), "
                  f"G {g}: {part[name]:.3f} ns per column, "
                  f"{part[name] / full:.4f} of the full variant")
        ns[g] = part
    n_launches = _nvcc.launched("probe.colband")
    by_rows = rows_launched("probe.colband")
    if set(by_rows) != {colband_probe.probe_rows(RW) for _name, RW, _sw in
                        colband_probe.VARIANTS + colband_probe.ABLATIONS}:
        raise AssertionError(f"probe launches by R {by_rows}")
    print(f"  {n_launches} timed launches, by R: {by_rows}")
    RW = colband_probe.ABLATION_RW
    b7 = b7_instances.get(colband_probe.probe_rows(RW))
    if b7 is None or b7["RW"] != RW:
        raise AssertionError(f"phase 12 split no B7 instance at RW {RW}")
    print(f"    beside B7 R={b7['split']['rows']} at RW {RW} (phase 12): "
          f"P1 {b7['p1_ns_per_col']:.3f} ns per column; its ", end="")
    colband_bench.print_split(b7["split"])
    full = ns[G][colband_probe.VARIANTS[0][0]]
    RW = colband_probe.VARIANTS[0][1]
    meta, prev = colband_probe.probe_inputs(G, ncols, "cuda")
    got = colband_probe.colband_probe_cuda(meta, prev, RW, ncols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = colband_probe.colband_probe_torch(meta, prev, RW, ncols)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, ref):
        raise AssertionError("probe, full size: instance != plain version")
    ms = full * G * ncols / 1e6
    bound_ms, bound_by = probe_bound(G * colband_probe.LN, RW, ncols, True)
    print(f"  full variant at RW={RW} (R={colband_probe.probe_rows(RW)}), "
          f"{G * colband_probe.LN} pairs, {ncols} columns: {ms:.3f} ms a "
          f"launch, plain version {plain_ms:.3f} ms, equal; bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"launches": n_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# --- the B1-substep probes: P3 (waves) and P4 (skewed frame) -------------


def ragged_meta(rng, n: int, lo: int, hi: int) -> torch.Tensor:
    """(n, 2) int32 [qlen, rlen] on the card, each drawn in [lo, hi)."""
    return torch.from_numpy(rng.integers(lo, hi, (n, 2)).astype(
        np.int32)).cuda()


def compare_substep(name, instance, plain) -> int:
    """A probe instance against its plain version on the same CUDA
    tensors, the four outputs and the whole final state; both callables
    take ``return_state``.  Returns max |err|."""
    got, state = instance(return_state=True)
    ref, ref_state = plain(return_state=True)
    torch.cuda.synchronize()
    err = max(int((got - ref).abs().max()),
              int((state.to(torch.int64) - ref_state).abs().max()))
    print(f"  {name}: max_abs_err={err} (outputs and the final state, "
          f"{state.shape[1]} lanes)")
    if not (torch.equal(got, ref) and torch.equal(state, ref_state)):
        bad = (state != ref_state).any(dim=0).nonzero().flatten()[:5]
        raise AssertionError(f"{name}: instance != plain version (state "
                             f"lanes {bad.tolist()})")
    return err


def time_substep(name, instance, plain, meta, W, n_diags, **switches):
    """An instance at full width against its plain version (outputs and
    state), both timed on the same inputs, with the bound: 12 operations
    per C-true cell (counted by the plain version's masks) and 15 per
    live pair-wave substep, or the bytes of meta and out; and the
    contract's floor, 12 operations a lane-substep."""
    err = compare_substep(name, instance, plain)
    ms = cuda_ms(instance, reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cells = substep_probe.count_cells(meta, W, n_diags, **switches)
    live = int(ref[:, 3].to(torch.int64).sum())
    bound_ms, bound_by = bound(4 * (meta.numel() + ref.numel()),
                               OPS_PER_CELL * cells + OPS_PER_DIAG * live)
    lane_substeps = (meta.shape[0] * W * switches.get("n_waves", 1) * 8
                     * n_diags)
    floor_ms = OPS_PER_LANE_SUBSTEP * lane_substeps / INT32_OPS_PER_S * 1e3
    print(f"    {ms:.4f} ms a launch, plain version {plain_ms:.3f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}; {cells} C-true cells, "
          f"{live} live pair-wave substeps), contract floor "
          f"{floor_ms:.6f} ms ({lane_substeps} lane-substeps; "
          f"{ms / floor_ms:.2f}x)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_wave_probe(rng) -> dict:
    """P3: every instance == wave_probe_torch (small, ragged, past the
    feed phase's wrap), the original's five timed variants, then the
    base variant at full size."""
    err = 0
    meta = ragged_meta(rng, 64, 90, 462)
    for nw in (1, 2, 4):
        err = max(err, compare_substep(
            f"P3 waves={nw} W=256, 64 pairs, 20 packed diagonals",
            lambda nw=nw, **kw: wave_probe.wave_probe_cuda(
                meta, 256, nw, 20, **kw),
            lambda nw=nw, **kw: wave_probe.wave_probe_torch(
                meta, 256, nw, 20, **kw)))
    G, n_diags = 32, 312 // 8
    _nvcc.launches.clear()
    wave_probe.run_all(G, n_diags)
    n_launches = _nvcc.launches["probe.wave"]
    if n_launches == 0:
        raise AssertionError("P3: no instance launched")
    _name, B, W, nw, per = wave_probe.VARIANTS[0]
    meta = ragged_meta(rng, G * per * B, 100, 200)
    full = time_substep(
        f"P3 base at full size: {meta.shape[0]} pairs, W={W}, {n_diags} "
        "packed diagonals, ragged 100-199",
        lambda **kw: wave_probe.wave_probe_cuda(meta, W, nw, n_diags, **kw),
        lambda **kw: wave_probe.wave_probe_torch(meta, W, nw, n_diags, **kw),
        meta, W, n_diags, n_waves=nw)
    return {**full, "launches": n_launches,
            "max_abs_err": max(err, full["max_abs_err"])}


def phase_skew_probe(rng, b2_ns_per_diag: float) -> dict:
    """P4: every instance == skew_probe_torch at full width (small,
    ragged), the original's four timed variants at G 16 x 2400 packed
    diagonals (128 blocks) on ragged ~12 kb meta, then all four at that
    width and block count against the plain version on fewer diagonals."""
    err = 0
    small = ragged_meta(rng, 16, 200, 1400)
    for name, W, frame, masks in skew_probe.VARIANTS:
        err = max(err, compare_substep(
            f"P4 {name} W={W}, 16 pairs, 20 packed diagonals",
            lambda W=W, frame=frame, masks=masks, **kw:
                skew_probe.skew_probe_cuda(small, W, 20, frame=frame,
                                           masks=masks, **kw),
            lambda W=W, frame=frame, masks=masks, **kw:
                skew_probe.skew_probe_torch(small, W, 20, frame=frame,
                                            masks=masks, **kw)))
    G, n_diags = 16, 2400
    meta = ragged_meta(rng, G * skew_probe.B, 11000, 13001)
    _nvcc.launches.clear()
    res = skew_probe.run_all(G, n_diags, meta=meta)
    n_launches = _nvcc.launches["probe.skew"]
    if n_launches == 0:
        raise AssertionError("P4: no instance launched")
    cur = res["current"]["block_ns"]
    ratio = cur / b2_ns_per_diag
    print(f"  P4 current: {cur:.2f} ns per substep per block; B2 on the "
          f"fewest-diagonal headline bucket (phase 4): "
          f"{b2_ns_per_diag:.2f} ns per base diagonal ({ratio:.4f}x)")
    n_short = 150
    full = {}
    for name, W, frame, masks in skew_probe.VARIANTS:
        full[name] = time_substep(
            f"P4 {name} at full width: {meta.shape[0]} pairs, W={W}, "
            f"{n_short} packed diagonals",
            lambda W=W, frame=frame, masks=masks, **kw:
                skew_probe.skew_probe_cuda(meta, W, n_short, frame=frame,
                                           masks=masks, **kw),
            lambda W=W, frame=frame, masks=masks, **kw:
                skew_probe.skew_probe_torch(meta, W, n_short, frame=frame,
                                            masks=masks, **kw),
            meta, W, n_short, skewed=frame == "skewed",
            ival=masks == "interval")
        err = max(err, full[name]["max_abs_err"])
    return {**full["current"], "launches": n_launches, "max_abs_err": err}

# --- the command line, streaming and the stress gate ---------------------

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
CANON_FLAGS = ["-m", "1", "-x", "4", "-q", "6", "-r", "2", "-s", "3",
               "-z", "400", "-w", "751"]


def cli_cmd(*args) -> list[str]:
    return [sys.executable, "-m", "agatha_tpu_torch.cli", *map(str, args)]


def cli_env() -> dict:
    """The environment of a command-line run: the repo root on
    PYTHONPATH, since the runs start in a temporary directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def cli_runs(named_cmds, cwd) -> dict:
    """Run command lines at once, each as a subprocess writing to files
    in cwd; returns per name its stdout, wall ms and the numbers of its
    stderr lines.  Raises on a non-zero exit, after stopping the rest."""
    procs = {}
    for name, cmd in named_cmds:
        paths = [os.path.join(cwd, f"{name}.{x}".replace(" ", "_"))
                 for x in ("out", "err")]
        with open(paths[0], "w") as fo, open(paths[1], "w") as fe:
            procs[name] = (time.perf_counter(), paths, subprocess.Popen(
                cmd, cwd=cwd, env=cli_env(), stdout=fo, stderr=fe))
    out = {}
    try:
        for name, (t0, paths, proc) in procs.items():
            proc.wait(timeout=900)
            wall = (time.perf_counter() - t0) * 1e3
            stdout, stderr = (open(p).read() for p in paths)
            if proc.returncode != 0:
                raise AssertionError(f"command line {name} exited "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            nums = dict(re.findall(r"(pairs|buckets|chunks)=(\d+)", stderr))
            out[name] = {
                "stdout": stdout,
                "process_ms": float(re.search(
                    r"process time \(in milliseconds\): ([0-9.]+)",
                    stderr).group(1)),
                "wall_ms": wall, "lines": stdout.count("\n"),
                **{k: int(v) for k, v in nums.items()},
            }
    finally:
        for _t0, _paths, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def cli_run(name, cmd, cwd) -> dict:
    return cli_runs([(name, cmd)], cwd)[name]


def expect_equal(what: str, got: str, want: str) -> None:
    if got != want:
        a, b = got.splitlines(), want.splitlines()
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        raise AssertionError(f"{what}: line {i} differs ({len(a)} against "
                             f"{len(b)} lines): {a[i:i + 1]} vs {b[i:i + 1]}")


def result_text(res, cigar=False) -> str:
    buf = io.StringIO()
    cli._emit_result_lines(res, cigar, buf)
    return buf.getvalue()


def parse_lines(stdout: str) -> SimpleNamespace:
    """Scores, ends and CIGARs of the command line's result lines."""
    rows = [ln.split("\t") for ln in stdout.splitlines()]
    col = lambda k: np.array([int(r[k].split("=")[-1]) for r in rows])
    return SimpleNamespace(scores=col(0), query_ends=col(1),
                           target_ends=col(2),
                           cigars=[r[3][len("cigar="):] for r in rows])


def tb_bitmap_bytes(engine, encoded, chunk: int) -> int:
    """The largest flag bitmap of any traceback bucket of the chunks."""
    big = 0
    for lo in range(0, len(encoded), chunk):
        for b in engine.iter_buckets(encoded[lo:lo + chunk],
                                     lane_kernels_ok=False):
            for sb in engine._split_for_flags(b):
                planes = kernel.flag_planes_needed(sb.meta, CANON)
                w = min(2 * sb.tcodes.shape[1], window_width(CANON))
                big = max(big, sb.meta.shape[0] * planes * w * 4)
    return big


def phase_cli() -> dict:
    """The command line as a user runs it, each call a subprocess from a
    temporary directory: the golden logs, both traceback modes, the
    headline set from make_dataset in AGAThA.sh's order (batch, raw.log,
    --stream, avg_time) against an in-process align, and 8192 x 150 bp
    with --stream --cigar against the batch run and the rescore."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        return cli_phase_in(tmp)


def cli_phase_in(tmp: str) -> dict:
    g = lambda f: os.path.join(GOLDEN, f)
    canon = ["-p", "-m", "1", "-x", "4", "-q", "6", "-r", "2"]
    runs = cli_runs([
        ("golden", cli_cmd(*canon, g("query.fasta"), g("target.fasta"))),
        ("golden2", cli_cmd(*canon, "-w", "15", "-z", "-1",
                            g("query2.fasta"), g("target2.fasta"))),
        ("cigar device", cli_cmd(*canon, "--cigar", "--tb-mode", "device",
                                 g("query.fasta"), g("target.fasta"))),
        ("cigar host", cli_cmd(*canon, "--cigar", "--tb-mode", "host",
                               g("query.fasta"), g("target.fasta"))),
    ], tmp)
    for name, log in (("golden", "score.log"), ("golden2", "score2.log")):
        with open(g(log)) as f:
            expect_equal(name, runs[name]["stdout"], f.read())
    expect_equal("--tb-mode device against host",
                 runs["cigar device"]["stdout"], runs["cigar host"]["stdout"])
    expect_equal("--cigar lines without the CIGAR column",
                 "".join(ln.split("\tcigar=")[0] + "\n" for ln in
                         runs["cigar device"]["stdout"].splitlines()),
                 runs["golden"]["stdout"])
    print("  golden score.log / score2.log byte for byte; --cigar equal "
          "for --tb-mode device and host")

    # the headline set, AGAThA.sh's order: ref.fasta in the query slot
    head = os.path.join(tmp, "headline")
    t0 = time.perf_counter()
    make_dataset.write_dataset(head, 1024, 10000)
    gen_s = time.perf_counter() - t0
    ref, qry = os.path.join(head, "ref.fasta"), os.path.join(head,
                                                            "query.fasta")
    raw = os.path.join(head, "raw.log")
    runs["headline"] = cli_run("headline", cli_cmd(
        "-p", *CANON_FLAGS, ref, qry, raw), tmp)
    runs["headline stream"] = cli_run("headline stream", cli_cmd(
        "-p", "--stream", "-a", "256", *CANON_FLAGS, ref, qry), tmp)
    subprocess.run([sys.executable, "-m", "agatha_tpu_torch.scripts.avg_time",
                    "AGAThA-torch", "headline", raw,
                    os.path.join(head, "time.json"), "1"],
                   cwd=tmp, env=cli_env(), check=True)
    with open(os.path.join(head, "time.json")) as f:
        avg = json.load(f)["AGAThA-torch"]["headline"]
    engine = AlignEngine(CANON, device="cuda")
    encoded = engine.encode_pairs(read_fasta_pairs(ref, qry))
    engine.align(encoded)  # warm-up
    _nvcc.launches.clear()
    res = engine.align(encoded)
    got = counts()
    if got != (res.n_buckets, 0, 0, 0, 0):
        raise AssertionError(f"in-process headline align: launches {got} "
                             f"for {res.n_buckets} buckets")
    expect_equal("headline command line against an in-process align",
                 runs["headline"]["stdout"], result_text(res))
    expect_equal("headline --stream -a 256 against batch",
                 runs["headline stream"]["stdout"],
                 runs["headline"]["stdout"])
    with open(raw) as f:
        raw_lines = f.read().split()
    if not (len(raw_lines) == res.n_buckets == runs["headline"]["buckets"]
            and runs["headline stream"]["chunks"] == -(-len(encoded)
                                                       // 256)):
        raise AssertionError(f"raw.log {len(raw_lines)} lines, buckets "
                             f"{res.n_buckets} / {runs['headline']}, chunks "
                             f"{runs['headline stream']['chunks']}")
    if abs(avg - sum(float(x) for x in raw_lines)) > 1e-6 * avg:
        raise AssertionError(f"time.json {avg} != the sum of raw.log")
    print(f"  headline (make_dataset {gen_s:.2f} s): stdout == in-process "
          f"align (launches B1/B2, B3, B4, B5, B6 {got}), --stream -a 256 "
          f"== batch, raw.log {len(raw_lines)} lines (one a bucket), "
          f"time.json {avg:.3f} ms")

    # 8192 x 150 bp, --stream --cigar -a 2048 against batch --cigar
    short = os.path.join(tmp, "short")
    make_dataset.write_dataset(short, 8192, 150, spread=0.05)
    ref, qry = os.path.join(short, "ref.fasta"), os.path.join(short,
                                                             "query.fasta")
    runs["150 bp stream cigar"] = cli_run("150 bp stream cigar", cli_cmd(
        "--stream", "--cigar", "-a", "2048", *CANON_FLAGS, ref, qry), tmp)
    runs["150 bp cigar"] = cli_run("150 bp cigar", cli_cmd(
        "--cigar", *CANON_FLAGS, ref, qry), tmp)
    expect_equal("150 bp --stream --cigar against batch --cigar",
                 runs["150 bp stream cigar"]["stdout"],
                 runs["150 bp cigar"]["stdout"])
    stream_engine = AlignEngine(CANON, EngineConfig(aligns_per_batch=2048),
                                device="cuda")
    encoded = stream_engine.encode_pairs(read_fasta_pairs(ref, qry))
    check_cigars("150 bp --stream --cigar",
                 parse_lines(runs["150 bp stream cigar"]["stdout"]),
                 encoded, CANON)
    list(stream_engine.align_stream(iter(encoded[:2048]), traceback=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _nvcc.launches.clear()
    chunks = list(stream_engine.align_stream(iter_fasta_pairs(ref, qry),
                                             traceback=True))
    peak = torch.cuda.max_memory_allocated()
    got = counts()
    n_buckets = sum(c.n_buckets for c in chunks)
    if got != (0, n_buckets, 0, 0, n_buckets):
        raise AssertionError(f"in-process stream: launches {got} for "
                             f"{n_buckets} buckets")
    expect_equal("150 bp in-process align_stream against the command line",
                 "".join(result_text(c, True) for c in chunks),
                 runs["150 bp stream cigar"]["stdout"])
    big = tb_bitmap_bytes(stream_engine, encoded, 2048)
    if peak > 2 * big + 2**30:
        raise AssertionError(f"150 bp stream: peak {peak} bytes exceeds "
                             "two bitmaps + 1 GiB")
    print(f"  150 bp: --stream --cigar -a 2048 == batch --cigar, every "
          f"CIGAR rescored; in-process align_stream ({len(chunks)} chunks, "
          f"launches B1/B2, B3, B4, B5, B6 {got}) == the command line, "
          f"peak allocated {peak / 2**30:.4f} GiB (largest bitmap "
          f"{big / 2**30:.4f} GiB)")
    print(json.dumps({"cli_runs": [
        {"run": name, **{k: v for k, v in r.items() if k != "stdout"}}
        for name, r in runs.items()]}))
    return runs


def phase_engine_stress() -> dict:
    """engine_stress's gate on the card: one round of each of its three
    configs, one with colband, one with device traceback."""
    times = {}
    for label, argv in (("3 configs", ["3", "2024"]),
                        ("colband", ["1", "2024", "--colband"]),
                        ("traceback", ["1", "2025", "--traceback"])):
        t0 = time.perf_counter()
        if engine_stress.main(argv) != 0:
            raise AssertionError(f"engine_stress {' '.join(argv)} failed")
        times[label] = time.perf_counter() - t0
    print("  engine_stress seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()) + "; every pair bit-exact")
    return times


# --- 19: the multi-device dispatch over pinned slots ---------------------

FIELDS = ("scores", "query_ends", "target_ends", "diags")


def multi_slots() -> tuple:
    """Phase 19's slots: every card when there are several, else two
    slots on card 0.  Each slot is one part of the shard split or one
    turn of the round-robin; two on one card run one after the other on
    its current stream."""
    if torch.cuda.device_count() > 1:
        return make_pairs_mesh()
    return make_pairs_mesh(["cuda:0", "cuda:0"])


def pinned_engine(engine_cfg=None) -> AlignEngine:
    engine = AlignEngine(CANON, engine_cfg, device="cuda")
    engine._devices = multi_slots()
    return engine


def expect_fields(name, got, ref, fields=FIELDS) -> None:
    for f in fields:
        if not (getattr(got, f) == getattr(ref, f)).all():
            bad = np.nonzero(getattr(got, f) != getattr(ref, f))[0][:5]
            raise AssertionError(f"{name}: {f} != the single-device run "
                                 f"at {bad}")


class SlotSpy:
    """Spies on the engine's bucket copies and one route's wrapper: it
    records the slot (by identity in the pinned list) each bucket is
    copied to, and checks that the wrapper gets its inputs on that
    slot's device while that device is current."""

    def __init__(self, engine, wrapper: str):
        self.slots = engine._slots()
        self.wrapper = wrapper
        self.seen: list[int] = []
        self.calls = 0

    def __enter__(self):
        self.saved = {n: getattr(engine_mod, n)
                      for n in ("host_to_device", self.wrapper)}
        copy, run = self.saved["host_to_device"], self.saved[self.wrapper]

        def spy_copy(arrays, dev):
            self.seen.append(next(k for k, s in enumerate(self.slots)
                                  if s is dev))
            return copy(arrays, dev)

        def spy_run(meta, *args, **kw):
            dev = self.slots[self.seen[-1]]
            if (meta.device != dev
                    or torch.cuda.current_device() != dev.index):
                raise AssertionError(
                    f"{self.wrapper}: inputs on {meta.device}, current "
                    f"device {torch.cuda.current_device()}, slot {dev}")
            self.calls += 1
            return run(meta, *args, **kw)

        engine_mod.host_to_device = spy_copy
        setattr(engine_mod, self.wrapper, spy_run)
        return self

    def __exit__(self, *exc):
        for name, f in self.saved.items():
            setattr(engine_mod, name, f)

    def check_turns(self, n_buckets: int) -> None:
        n = len(self.slots)
        if (self.calls != n_buckets
                or self.seen != [k % n for k in range(n_buckets)]):
            raise AssertionError(f"{self.wrapper}: {self.calls} calls, "
                                 f"slots {self.seen} for {n_buckets} "
                                 "buckets taken in turn")


def round_robin(name, engine, single, encoded, wrapper, ref, expect, **kw):
    """One align() through the round-robin with its launches counted and
    its slots spied on, checked for routes, launches, turns and all four
    fields against ref; then its wall and the single-device engine's,
    in turns.  Returns the result, the launches, the two walls (ms) and
    the counted align's B7 launches by rows a thread ({R: n})."""
    engine.align(encoded, **kw)  # warm-up
    _nvcc.launches.clear()
    with SlotSpy(engine, wrapper) as spy:
        res = engine.align(encoded, **kw)
    got = counts() + (_nvcc.launched("colband"),)
    by_rows = rows_launched("colband")
    nb = res.n_buckets
    if res.routes != [expect[0]] * nb or got != expect[1](nb) or nb == 0:
        raise AssertionError(f"{name}: routes {sorted(set(res.routes))}, "
                             f"launches {got} for {nb} buckets")
    spy.check_turns(nb)
    expect_fields(name, res, ref)
    print(f"  {name}: {nb} buckets, routes {sorted(set(res.routes))}, "
          f"launches B1/B2, B3, B4, B5, B6, B7 {got}, slots "
          f"{spy.seen[:8]}{'...' if nb > 8 else ''} in turn; all "
          f"{len(encoded)} pairs equal the single-device run in all four "
          "fields")
    one, rr = best_walls((single, engine), encoded, ref, **kw)
    print(f"      walls in turns (best of 3): single device {one * 1e3:.3f} "
          f"ms, round-robin {rr * 1e3:.3f} ms, ratio {rr / one:.4f}")
    return res, got, [one * 1e3, rr * 1e3], by_rows


WORKER = r"""
import pickle, sys, time
t0 = time.perf_counter()
import numpy as np
import torch.distributed as dist
from agatha_tpu_torch import AlignConfig, AlignEngine
from agatha_tpu_torch.parallel import distributed

coord, rank, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
t_import = time.perf_counter()
distributed.initialize(coord, 2, rank)
t_init = time.perf_counter()
with open(inp, "rb") as f:
    encoded = pickle.load(f)  # the shared input list, the same for both
engine = AlignEngine(AlignConfig(match=1, mismatch=4, gap_open=6,
                                 gap_extend=2, slice_width=3,
                                 z_threshold=400, band_width=751),
                     device="cuda")
engine.align(encoded[distributed.host_shard(len(encoded))])  # warm-up
t_warm = time.perf_counter()
dist.barrier()
t1 = time.perf_counter()
sl, res = distributed.align_distributed(engine, encoded)
wall = time.perf_counter() - t1
dist.barrier()
both = time.perf_counter() - t1
dist.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "agatha_tpu")]
assert not bad, bad
np.savez(out, start=sl.start, stop=sl.stop, routes=np.array(res.routes),
         scores=res.scores, query_ends=res.query_ends,
         target_ends=res.target_ends, diags=res.diags, wall_ms=wall * 1e3,
         both_ms=both * 1e3, process_ms=(time.perf_counter() - t0) * 1e3,
         import_ms=(t_import - t0) * 1e3, init_ms=(t_init - t_import) * 1e3,
         warm_ms=(t_warm - t_init) * 1e3)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_processes(encoded, ref) -> dict:
    """Two processes, each AlignEngine(device="cuda"), join a gloo group
    over 127.0.0.1 (parallel.distributed.initialize) and align their
    host_shard of the same input list (written to a file once); the
    merged fields equal ref."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        inp = os.path.join(tmp, "encoded.pkl")
        with open(inp, "wb") as f:
            pickle.dump(encoded, f)
        coord = f"127.0.0.1:{free_port()}"
        procs = []
        t0 = time.perf_counter()
        for rank in range(2):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            out = os.path.join(tmp, f"rank{rank}.npz")
            procs.append((out, log, subprocess.Popen(
                [sys.executable, "-c", WORKER, coord, str(rank), inp, out],
                cwd=tmp, env=cli_env(), stdout=log,
                stderr=subprocess.STDOUT)))
        try:
            for _out, _log, proc in procs:
                proc.wait(timeout=300)
        finally:
            for _out, log, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        wall = (time.perf_counter() - t0) * 1e3
        for rank, (_out, _log, proc) in enumerate(procs):
            if proc.returncode != 0:
                with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                    raise AssertionError(f"rank {rank} exited "
                                         f"{proc.returncode}: "
                                         f"{f.read()[-2000:]}")
        shards = [dict(np.load(out)) for out, _log, _proc in procs]
    n = len(ref.scores)
    merged = {f: np.full(n, -1, np.int64) for f in FIELDS}
    for d in shards:
        lo, hi = int(d["start"]), int(d["stop"])
        for f in FIELDS:
            merged[f][lo:hi] = d[f]
    spans = [(int(d["start"]), int(d["stop"])) for d in shards]
    if spans != [(0, n // 2), (n // 2, n)]:
        raise AssertionError(f"host shards {spans}")
    expect_fields("two processes", SimpleNamespace(**merged), ref)
    out = {"wall_ms": wall, "ranks": [
        {k: float(d[k]) for k in ("wall_ms", "both_ms", "process_ms",
                                  "import_ms", "init_ms", "warm_ms")}
        for d in shards]}
    print(f"  (f) two processes on 127.0.0.1 (gloo): shards {spans}, routes "
          f"{[sorted(set(d['routes'].tolist())) for d in shards]}; the "
          "merged four fields equal the single-process run (phase 4)")
    for rank, r in enumerate(out["ranks"]):
        print(f"      rank {rank}: align of its shard {r['wall_ms']:.3f} ms "
              f"(both ranks done {r['both_ms']:.3f} ms), process "
              f"{r['process_ms']:.1f} ms (imports {r['import_ms']:.1f}, "
              f"rendezvous {r['init_ms']:.1f}, input and warm-up "
              f"{r['warm_ms']:.1f})")
    print(f"      wall from starting both to both exited {wall:.1f} ms")
    return out


def phase_multi(head, s150, tb_head, cb_head) -> dict:
    """The multi-device paths through pinned slots: the sharded primitive
    and headline, the colsweep and colband round-robins, device
    traceback over split sub-buckets in turn, and two processes."""
    slots = multi_slots()
    n = len(slots)
    print(f"  slots {[str(d) for d in slots]}: " + (
        "two slots on the one card" if torch.cuda.device_count() == 1
        else f"every card ({n})"))
    encoded = head["encoded"]

    # (a) the raw sharded primitive against align_bucket on one device
    meta, tcodes, qfwd = build_bucket_arrays(encoded[:13], CANON)
    unit = n * kernel.B_PAIRS
    gb = -(-meta.shape[0] // unit) * unit
    padded = (pad_rows(meta, gb, 1), pad_rows(tcodes, gb),
              pad_rows(qfwd, gb))
    _nvcc.launches.clear()
    shards = align_bucket_sharded(*padded, CANON, slots)
    launches = _nvcc.launches["antidiag.score"]
    got = torch.cat([s.to(slots[0]) for s in shards])
    ref = align_bucket(*to_cuda(*padded), CANON)
    if launches != n or not torch.equal(got, ref):
        raise AssertionError(f"sharded primitive: {launches} launches, "
                             f"equal {torch.equal(got, ref)}")
    print(f"  (a) align_bucket_sharded: 13 headline pairs padded to {gb} "
          f"rows, {n} launches of {gb // n} rows, equal to align_bucket "
          "on one device")

    # (b) the headline, sharded, both walls in turns
    sharded = pinned_engine()
    sharded.align(encoded)  # warm-up
    _nvcc.launches.clear()
    res = sharded.align(encoded)
    got = counts()
    nb = res.n_buckets
    if res.routes != ["anti-sharded"] * nb or got != (n * nb, 0, 0, 0, 0):
        raise AssertionError(f"sharded headline: routes "
                             f"{sorted(set(res.routes))}, launches {got} "
                             f"for {nb} buckets")
    expect_fields("sharded headline", res, head["res"])
    single = AlignEngine(CANON, device="cuda")
    single.align(encoded)  # warm-up
    wall_one, wall_sh = best_walls((single, sharded), encoded, head["res"])
    timed = sharded.align(encoded, per_bucket_times=True)
    print(f"  (b) headline sharded: {nb} buckets, routes "
          f"{sorted(set(res.routes))}, launches B1/B2, B3, B4, B5, B6 {got} "
          f"({n} a bucket); all four fields equal phase 4's")
    print(f"      walls in turns (best of 3): single device "
          f"{wall_one * 1e3:.3f} ms, {n} slots {wall_sh * 1e3:.3f} ms, "
          f"ratio {wall_sh / wall_one:.4f} (phase 4: "
          f"{head['wall_ms']:.3f} ms); sharded bucket CUDA-event ms sum "
          f"{sum(timed.bucket_ms):.3f}")
    out = {"slots": [str(d) for d in slots],
           "launches": {"antidiag": got[0]},
           "wall_single_ms": wall_one * 1e3, "wall_sharded_ms": wall_sh * 1e3}

    # (c) 8192 x 150 bp through the colsweep round-robin
    _res, got, out["walls_colsweep"], _r = round_robin(
        "(c) 150 bp colsweep round-robin", pinned_engine(),
        AlignEngine(CANON, device="cuda"), s150["encoded"],
        "align_bucket_colsweep", s150["res"],
        ("colsweep", lambda nb: (0, 0, nb, nb, 0, 0)))
    out["launches"].update(colsweep_sweep=got[2], colsweep_chain=got[3])

    # (d) the headline through the colband round-robin
    _res, got, out["walls_colband"], by_rows = round_robin(
        "(d) headline colband round-robin",
        pinned_engine(EngineConfig(colband=True)),
        AlignEngine(CANON, EngineConfig(colband=True), device="cuda"),
        encoded, "align_bucket_colband", cb_head["res"],
        ("colband", lambda nb: (0, 0, 0, 0, 0, nb)))
    out["launches"]["colband"] = got[5]
    out["launches"].update({f"colband_r{r}": n for r, n in by_rows.items()})

    # (e) the headline with CIGARs: sub-buckets in turn
    tb_engine = pinned_engine()
    res, got, out["walls_traceback"], _r = round_robin(
        "(e) headline + CIGARs round-robin", tb_engine, tb_head["engine"],
        encoded, "align_bucket_traceback", tb_head["res"],
        ("walk", lambda nb: (0, nb, 0, 0, nb, 0)), traceback=True)
    parts = [len(list(tb_engine._split_for_flags(b, n_parts=n)))
             for b in tb_engine.iter_buckets(encoded, lane_kernels_ok=False)]
    if res.n_buckets != sum(parts) or min(parts) < n:
        raise AssertionError(f"traceback split {parts} for "
                             f"{res.n_buckets} sub-buckets over {n} slots")
    if res.cigars != tb_head["res"].cigars:
        raise AssertionError("round-robin CIGARs != phase 9's")
    check_cigars("headline + CIGARs round-robin", res, encoded, CANON)
    print(f"      {len(parts)} buckets split into {min(parts)}-{max(parts)} "
          f"parts each ({res.n_buckets} sub-buckets); CIGARs equal phase "
          "9's")
    out["launches"].update(antidiag_flags=got[1], walk=got[4])

    # (f) two processes, one host_shard each
    out["two_processes"] = two_processes(encoded, head["res"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(2024)
    pool = plain_pool()  # its processes start while phases 0-3 run
    ont = ont_pool()
    ont_job = ont.apply_async(ont_plain)  # runs beside phases 0-15
    with Phase("0 card"):
        smi = phase_card()
    with Phase("1 build"):
        phase_build()
    with Phase("2 kernel vs plain version"):
        err = phase_kernel_vs_plain(rng)
    with Phase("3 kernel vs oracle"):
        err = max(err, phase_oracle(rng))
    with Phase("3b kernel vs plain version, random buckets"):
        err = max(err, phase_random_buckets(pool))
    with Phase("4 headline 1024 x 10 kb"):
        head = phase_headline()
    with Phase("5 colsweep kernels vs plain versions"):
        cs_err = phase_colsweep_vs_plain(rng)
    with Phase("5b colsweep kernels vs plain versions, random buckets"):
        cs_err = max(cs_err, phase_colsweep_random())
    with Phase("6 colsweep vs oracle"):
        cs_err = max(cs_err, phase_colsweep_oracle(rng))
    with Phase("7a short reads 8192 x 150 bp"):
        s150 = phase_short_reads(150)
    with Phase("7b short reads 8192 x 600 bp"):
        s600 = phase_short_reads(600)
    cs_err = max(cs_err, s150["max_abs_err"], s600["max_abs_err"])
    with Phase("8 traceback kernels vs plain versions"):
        tb_err = phase_traceback_vs_plain(rng)
    with Phase("8b walk (B6) vs walk_torch, random buckets at headline "
               "width"):
        tb_err = max(tb_err, phase_walk_random())
    with Phase("9 headline 1024 x 10 kb with CIGARs"):
        tb_head = phase_headline_traceback(head["encoded"])
    with Phase("10 short reads 8192 x 150 bp with CIGARs"):
        tb_150 = phase_short_traceback()
    tb_err = max(tb_err, tb_head["max_abs_err"], tb_150["max_abs_err"])
    with Phase("11 colband kernel vs plain version, oracle, antidiag"):
        cb_err = phase_colband_vs_plain(rng)
    with Phase("11b colband kernel vs plain version and oracle, random "
               "buckets"):
        cb_err = max(cb_err, phase_colband_random(pool))
    pool.close()
    pool.join()
    with Phase("12 headline 1024 x 10 kb with colband"):
        cb_head = phase_headline_colband(head["encoded"])
    with Phase("12b headline set with colband at bw 255 and 1000"):
        cb_bands = phase_colband_bands(head["encoded"])
    with Phase("13 colband cost probe"):
        probe = phase_probe(cb_head["instances"])
    with Phase("14 wave-interleave probe (P3)"):
        waves = phase_wave_probe(rng)
    with Phase("15 skewed-frame probe (P4)"):
        skew = phase_skew_probe(rng, head["ns_per_diag"])
    with Phase("16 the longest ONT pair (past 65535 rows) vs plain "
               "version"):
        err = max(err, phase_ont_pair(ont_job))
    ont.close()
    ont.join()
    with Phase("17 the command line and streaming"):
        phase_cli()
    with Phase("18 engine stress"):
        phase_engine_stress()
    with Phase("19 multi-device dispatch over pinned slots"):
        multi = phase_multi(head, s150, tb_head, cb_head)
    src = "agatha_tpu_torch/csrc/colsweep.cu"
    kernels = [
        {"name": "antidiag", "route": "cuda",
         "source": "agatha_tpu_torch/csrc/antidiag.cu",
         "replaces": "agatha_tpu/ops/kernel.py:913",
         "launches": head["launches"],
         "max_abs_err": max(err, head["max_abs_err"]),
         "ms": head["ms"], "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": None},
    ]
    for name, key, line in (("colsweep_sweep", "sweep", 482),
                            ("colsweep_chain", "chain", 510)):
        t = s150[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"agatha_tpu/ops/colsweep.py:{line}",
            "launches": s150[f"launches_{key}"], "max_abs_err": cs_err,
            "ms": t["ms"], "graph_ms": t["graph_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    for name, key, src, replaces in (
        ("antidiag_flags", "b3", "agatha_tpu_torch/csrc/antidiag.cu",
         "agatha_tpu/ops/kernel.py:913"),
        ("walk", "b6", "agatha_tpu_torch/csrc/walk.cu",
         "agatha_tpu/ops/walk.py:392"),
    ):
        t = tb_head[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": tb_head["launches"],
            "max_abs_err": tb_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    cb_err = max(cb_err, cb_head["max_abs_err"],
                 *(t["max_abs_err"] for t in cb_bands.values()))
    # "colband": B7 as the headline's colband route launches it;
    # "colband_r<R>": each instance on the colband path whose band makes
    # the engine take it (phase 12 or 12b), with that run's launches and
    # its fewest-column bucket's times
    paths = {cb_head["rows"]: cb_head, **cb_bands}
    if sorted(paths) != sorted(cb.COLBAND_ROWS):
        raise AssertionError(f"the colband paths took instances "
                             f"{sorted(paths)}, not {cb.COLBAND_ROWS}")
    b7 = [("colband", cb_head)] + [(f"colband_r{rows}", paths[rows])
                                   for rows in cb.COLBAND_ROWS]
    for name, t, replaces in (
        *((n, {**t, "max_abs_err": cb_err}, "agatha_tpu/ops/colband.py:823")
          for n, t in b7),
        ("colband_probe", probe, "scripts/colband_probe.py:278"),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "agatha_tpu_torch/csrc/colband.cu",
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            **({"band": t["band"]} if "band" in t else {}),
        })
    for name, t, replaces in (
        ("wave_probe", waves, "scripts/wave_probe.py:266"),
        ("skew_probe", skew, "scripts/skew_probe.py:639"),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "agatha_tpu_torch/csrc/substep_probe.cu",
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    for k in kernels:  # launches in phase 19's runs (0: not on them)
        k["launches_multi"] = multi["launches"].get(k["name"], 0)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
