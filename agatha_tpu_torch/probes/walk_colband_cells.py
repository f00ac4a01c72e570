"""Times the walk (B6) and the banded column sweep (B7) in the cells that
carry them, end to end and per bucket, on one CUDA device.

    python -m agatha_tpu_torch.probes.walk_colband_cells [--colband]

prints, one line each, with the card's name and power limit first
(`--colband`: the colband cells alone):
- the headline with CIGARs (1024 x 10 kb, bw 751, `traceback=True`):
  wall, the score wall measured before and after it, tb/score, B6's
  CUDA-event ms on each bucket and their sum, and on the fewest-diagonal
  bucket (1536 planes) B6's ms and ns per plane of the longest path;
- the headline and HiFi (1024 x 15 kb) with `EngineConfig(colband=True)`:
  walls (one warm-up, best of 3, taken in turns with the default route),
  B7's CUDA-event ms per bucket in the engine and their sum, then for
  each B7 instance the package has (R rows a thread) its ms per bucket
  on staged inputs and their sum; on the headline's
  fewest-column bucket B2's ms, and for each instance B7's ms, P1's ns
  per column (`colband_bench`'s slope) and, where the package has it,
  B7's clock64 split of a column;
then one JSON line of every number.

It uses only the entry points every revision of the port has
(`AlignEngine`, `ops.kernel.align_bucket`, `ops.walk.walk`,
`ops.colband.colband_cuda`, `probes.colband_bench.bench_bucket`,
`probes.antidiag_cells.cuda_ms`), so that it can time another
revision's package in the same call: run it by path with
`PYTHONPATH=<other tree>` first on the path.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from agatha_tpu_torch import AlignConfig, AlignEngine, EngineConfig
from agatha_tpu_torch import make_workload
from agatha_tpu_torch.bench import device_line
from agatha_tpu_torch.ops import colband as cb
from agatha_tpu_torch.ops import kernel, walk
from agatha_tpu_torch.probes import colband_bench
from agatha_tpu_torch.probes.antidiag_cells import cuda_ms

CANON = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=400, band_width=751)


def walls(engines, encoded, reps=3, **kw) -> list[float]:
    """Best host-clock ms of align() for each engine, taken in turns
    after one warm-up each."""
    for e in engines:
        e.align(encoded, **kw)
    best = [float("inf")] * len(engines)
    for _ in range(reps):
        for i, e in enumerate(engines):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.align(encoded, **kw)
            best[i] = min(best[i], (time.perf_counter() - t0) * 1e3)
    return best


def tb_inputs(b):
    args = tuple(torch.from_numpy(a).cuda() for a in (b.meta, b.tcodes,
                                                       b.qfwd))
    planes = kernel.flag_planes_needed(b.meta, CANON)
    vbases = torch.from_numpy(walk.vbase_schedule(
        planes, CANON, 2 * b.tcodes.shape[1])).cuda()
    return args, planes, vbases


def traceback_cell() -> dict:
    encoded = make_workload(1024, 10000, seed=1234)
    engine = AlignEngine(CANON, device="cuda")
    score_before = walls([engine], encoded, reps=2)[0]
    tb = walls([engine], encoded, traceback=True)[0]
    score_after = walls([engine], encoded, reps=2)[0]
    score = min(score_before, score_after)
    res = engine.align(encoded, traceback=True)
    b6, fewest = [], None
    for b in engine.iter_buckets(encoded, lane_kernels_ok=False):
        args, planes, vbases = tb_inputs(b)
        out, flags = kernel.align_bucket(*args, CANON, emit_flags=True,
                                         planes=planes)
        ms = cuda_ms(lambda: walk.walk(flags, vbases, out), reps=3)
        b6.append(ms)
        diags = int(res.diags[b.indices].max())
        if fewest is None or diags < fewest[0]:
            fewest = (diags, b)
        del flags
    b = fewest[1]
    args, planes, vbases = tb_inputs(b)
    out, flags = kernel.align_bucket(*args, CANON, emit_flags=True,
                                     planes=planes)
    o = out.cpu()
    path_planes = int(((o[:, 1] + o[:, 2]) >> 3).max()) + 1
    ms = cuda_ms(lambda: walk.walk(flags, vbases, out), reps=5)
    r = {"tb_wall_ms": tb, "score_wall_ms": score, "tb_score": tb / score,
         "b6_bucket_ms": b6, "b6_sum_ms": sum(b6), "planes": planes,
         "path_planes": path_planes, "b6_ms": ms,
         "b6_ns_per_plane": ms * 1e6 / path_planes}
    print(f"headline with CIGARs: wall {tb:.3f} ms, score wall {score:.3f} "
          f"ms, tb/score {tb / score:.4f}; B6 per bucket "
          + " ".join(f"{m:.4f}" for m in b6) + f" (sum {sum(b6):.3f} ms)",
          flush=True)
    print(f"  fewest-diagonal bucket GB={b.meta.shape[0]} planes={planes} "
          f"longest path {path_planes} planes: B6 {ms:.4f} ms, "
          f"{r['b6_ns_per_plane']:.2f} ns per plane", flush=True)
    return r


def b7_instances(RW: int) -> list[dict]:
    """colband_cuda's keyword arguments for every B7 instance of the
    package that takes a window of RW rows: [{}] for a package of one
    instance (before the instances of rows a thread)."""
    if not hasattr(colband_bench, "instances"):
        return [{}]
    return [dict(rows=r) for r in colband_bench.instances(RW)]


def inst_name(kw: dict) -> str:
    return f"B7 R={kw['rows']}" if kw else "B7"


def colband_cell(name: str, n: int, mean_len: int) -> dict:
    encoded = make_workload(n, mean_len, seed=1234)
    on = AlignEngine(CANON, EngineConfig(colband=True), device="cuda")
    off = AlignEngine(CANON, device="cuda")
    wall_on, wall_off = walls([on, off], encoded)
    timed = on.align(encoded, per_bucket_times=True)
    r = {"wall_ms": wall_on, "default_wall_ms": wall_off,
         "b7_bucket_ms": timed.bucket_ms, "b7_sum_ms": sum(timed.bucket_ms)}
    print(f"{name} with colband: wall {wall_on:.3f} ms (default route in "
          f"turns {wall_off:.3f} ms); B7 per bucket "
          + " ".join(f"{m:.3f}" for m in timed.bucket_ms)
          + f" (sum {r['b7_sum_ms']:.3f} ms)", flush=True)
    buckets = list(on.iter_buckets(encoded))
    staged = [(colband_bench.stage_bucket(b.meta, b.tcodes, b.qfwd, CANON))
              for b in buckets]
    RW = staged[0][3][0]
    r["instances"] = {}
    for kw in b7_instances(RW):
        ms = [cuda_ms(lambda: cb.colband_cuda(*st[:3], CANON, st[3], **kw),
                      reps=3) for st in staged]
        r["instances"][inst_name(kw)] = {"bucket_ms": ms, "sum_ms": sum(ms)}
        print(f"  {inst_name(kw)} per bucket (events, staged inputs) "
              + " ".join(f"{m:.3f}" for m in ms)
              + f" (sum {sum(ms):.3f} ms)", flush=True)
    if name != "headline":
        return r
    b = min(buckets, key=lambda b: int(b.meta[:, 0].max()))
    scalars, tc, qf, shapes = colband_bench.stage_bucket(b.meta, b.tcodes,
                                                         b.qfwd, CANON)
    args = tuple(torch.from_numpy(a).cuda() for a in (b.meta, b.tcodes,
                                                       b.qfwd))
    b2 = cuda_ms(lambda: kernel.align_bucket(*args, CANON), reps=5)
    r.update(b2_ms=b2, gb=int(b.meta.shape[0]), fewest={})
    print(f"  fewest-column bucket GB={r['gb']} longest query "
          f"{int(b.meta[:, 0].max())}: B2 on it {b2:.4f} ms", flush=True)
    for kw in b7_instances(RW):
        ms = cuda_ms(lambda: cb.colband_cuda(scalars, tc, qf, CANON, shapes,
                                             **kw), reps=10)
        slope = colband_bench.bench_bucket(b.meta, b.tcodes, b.qfwd, CANON,
                                           reps=8, rounds=3, **kw)
        f = {"b7_ms": ms, "b7_ns_per_col": slope["ns_per_col"],
             "p1_ms": slope["ms"], "columns": slope["cols"],
             "b2_over_b7": b2 / ms}
        print(f"  {inst_name(kw)}: {ms:.4f} ms (B2 / B7 {b2 / ms:.4f}), P1 "
              f"slope {slope['ms']:.4f} ms per launch, "
              f"{slope['ns_per_col']:.3f} ns per column ({slope['cols']} "
              "columns)", flush=True)
        if hasattr(colband_bench, "column_split"):
            f["split"] = colband_bench.column_split(b.meta, b.tcodes,
                                                    b.qfwd, CANON, **kw)
            colband_bench.print_split(f["split"])
        r["fewest"][inst_name(kw)] = f
    return r


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("walk_colband_cells needs a CUDA device")
    print(device_line(), flush=True)
    print(f"package {kernel.__file__}", flush=True)
    out = {"device": device_line()}
    for lib in (walk.LIB, cb.LIB):
        lib.load()
        regs = [line.strip() for line in lib.log.splitlines()
                if "registers" in line or "spill" in line
                or "Compiling entry" in line]
        print("\n".join(f"ptxas {lib.source}: {x}" for x in regs),
              flush=True)
        out[f"ptxas_{lib.source}"] = regs
    if "--colband" not in argv:
        out["headline_tb"] = traceback_cell()
    out["headline_colband"] = colband_cell("headline", 1024, 10000)
    out["hifi_colband"] = colband_cell("hifi", 1024, 15000)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
