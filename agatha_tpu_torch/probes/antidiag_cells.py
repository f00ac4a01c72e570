"""Times the antidiagonal kernel (B1 / B2, and B3 with flags) in the
cells it carries, end to end and per bucket, on one CUDA device.

    python -m agatha_tpu_torch.probes.antidiag_cells [--skip-ont]

prints, one line each, with the card's name and power limit first:
the ptxas report of csrc/antidiag.cu; the headline (1024 x 10 kb, bw
751) wall, GCUPS, kernel sum and per-bucket CUDA-event ms, and the
fewest-diagonal bucket's ms and ns per base diagonal; HiFi (1024 x
15 kb) and ONT (128 x 75 kb, bw 2001) walls, as `agatha_tpu_torch.bench`
takes them (one warm-up, best of 3); the headline with CIGARs (wall,
the score wall measured before and after it, tb/score, peak allocated
memory, B3 and B6 on the 1536-plane bucket); the 8192 x 150 bp cell with
CIGARs (wall, tb/score, B3 on its first bucket); then one JSON line of
every number.

It uses only the entry points every revision of the port has
(`AlignEngine`, `ops.kernel.align_bucket`, `ops.walk.walk`), so that it
can time another revision's package in the same call: run it with
`PYTHONPATH=<other tree>` first on the path.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from agatha_tpu_torch import AlignConfig, AlignEngine, banded_cells
from agatha_tpu_torch import make_workload
from agatha_tpu_torch.bench import device_line
from agatha_tpu_torch.ops import kernel, walk


def cfg_of(bw: int) -> AlignConfig:
    return AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                       slice_width=3, z_threshold=400, band_width=bw)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def wall_ms(engine, encoded, reps=3, **kw) -> tuple[float, object]:
    """Best host-clock ms of `reps` align() calls (each ends in a copy to
    the host), after one warm-up; and the last result."""
    res = engine.align(encoded, **kw)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.align(encoded, **kw)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, res


def fewest_diag_bucket(engine, encoded, res, **kw):
    buckets = list(engine.iter_buckets(encoded, **kw))
    return min(buckets, key=lambda b: int(res.diags[b.indices].max()))


def score_cell(name: str, n: int, mean_len: int, bw: int) -> dict:
    cfg = cfg_of(bw)
    encoded = make_workload(n, mean_len, seed=1234)
    engine = AlignEngine(cfg, device="cuda")
    wall, res = wall_ms(engine, encoded)
    cells = banded_cells([e[2] for e in encoded], [e[3] for e in encoded],
                         res.diags, bw)
    timed = engine.align(encoded, per_bucket_times=True)
    out = {"wall_ms": wall, "gcups": cells / wall / 1e6,
           "kernel_sum_ms": sum(timed.bucket_ms),
           "bucket_ms": timed.bucket_ms, "buckets": res.n_buckets}
    print(f"{name}: wall {wall:.3f} ms, GCUPS {out['gcups']:.4f}, kernel "
          f"sum {out['kernel_sum_ms']:.3f} ms over {res.n_buckets} buckets: "
          + " ".join(f"{m:.3f}" for m in timed.bucket_ms), flush=True)
    if name == "headline":
        b = fewest_diag_bucket(engine, encoded, res)
        args = tuple(torch.from_numpy(a).cuda()
                     for a in (b.meta, b.tcodes, b.qfwd))
        ms = cuda_ms(lambda: kernel.align_bucket(*args, cfg), reps=5)
        diags = int(res.diags[b.indices].max())
        out.update(b2_ms=ms, b2_ns_per_diag=ms * 1e6 / diags,
                   b2_diags=diags, b2_gb=int(b.meta.shape[0]),
                   b2_w=int(2 * b.tcodes.shape[1]))
        print(f"  fewest-diagonal bucket GB={out['b2_gb']} "
              f"W={out['b2_w']} max diags {diags}: {ms:.3f} ms, "
              f"{out['b2_ns_per_diag']:.2f} ns per base diagonal",
              flush=True)
    return out


def traceback_cell(name: str, n: int, mean_len: int, spread: float) -> dict:
    cfg = cfg_of(751)
    encoded = make_workload(n, mean_len, seed=1234, spread=spread)
    engine = AlignEngine(cfg, device="cuda")
    score_before, res = wall_ms(engine, encoded, reps=2)
    tb, tres = wall_ms(engine, encoded, traceback=True)
    score_after, _r = wall_ms(engine, encoded, reps=2)
    score = min(score_before, score_after)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.align(encoded, traceback=True)
    peak = torch.cuda.max_memory_allocated()
    if name == "headline":
        b = fewest_diag_bucket(engine, encoded, tres, lane_kernels_ok=False)
    else:
        b = next(iter(engine.iter_buckets(encoded, lane_kernels_ok=False)))
    args = tuple(torch.from_numpy(a).cuda()
                 for a in (b.meta, b.tcodes, b.qfwd))
    planes = kernel.flag_planes_needed(b.meta, cfg)
    b3 = cuda_ms(lambda: kernel.align_bucket(*args, cfg, emit_flags=True,
                                             planes=planes), reps=3)
    out_, flags = kernel.align_bucket(*args, cfg, emit_flags=True,
                                      planes=planes)
    vbases = torch.from_numpy(
        walk.vbase_schedule(planes, cfg, 2 * b.tcodes.shape[1])).cuda()
    b6 = cuda_ms(lambda: walk.walk(flags, vbases, out_), reps=5)
    del flags
    out = {"tb_wall_ms": tb, "score_wall_ms": score, "tb_score": tb / score,
           "peak_gib": peak / 2**30, "b3_ms": b3, "b6_ms": b6,
           "planes": planes}
    print(f"{name} with CIGARs: wall {tb:.3f} ms, score wall {score:.3f} "
          f"ms, tb/score {tb / score:.4f}, peak {peak / 2**30:.4f} GiB; "
          f"bucket GB={b.meta.shape[0]} planes={planes}: B3 {b3:.3f} ms, "
          f"B6 {b6:.4f} ms", flush=True)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("antidiag_cells needs a CUDA device")
    print(device_line(), flush=True)
    print(f"package {kernel.__file__}", flush=True)
    kernel.LIB.load()
    regs = [line.strip() for line in kernel.LIB.log.splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line]
    print("\n".join(regs), flush=True)
    out = {"device": device_line(), "ptxas": regs}
    if hasattr(kernel, "occupancy"):
        out["blocks_per_sm"] = {
            str(bw): [kernel.occupancy(cfg_of(bw), wt, safe16=s,
                                       emit_flags=e)
                      for s in (True, False) for e in (False, True)]
            for bw, wt in ((751, 10240), (2001, 76800))}
        print(f"resident blocks per SM (safe16 score/flags, strips "
              f"score/flags): {out['blocks_per_sm']}", flush=True)
    out["headline"] = score_cell("headline", 1024, 10000, 751)
    out["hifi"] = score_cell("hifi", 1024, 15000, 751)
    if "--skip-ont" not in argv:
        out["ont"] = score_cell("ont", 128, 75000, 2001)
    out["headline_tb"] = traceback_cell("headline", 1024, 10000, 0.5)
    out["short150_tb"] = traceback_cell("150 bp", 8192, 150, 0.05)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
