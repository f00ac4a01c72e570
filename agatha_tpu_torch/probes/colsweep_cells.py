"""Times the column-sweep kernels (B4 sweep, B5 chain) in the short-read
cells that carry them, end to end and per bucket, on one CUDA device.

    python -m agatha_tpu_torch.probes.colsweep_cells

prints, one line each, with the card's name and power limit first, for
8192 x 150 bp and 8192 x 600 bp (`make_workload(seed=1234, spread=0.05)`,
bw 751): the routes and launches of one `align`; the wall (one warm-up,
best of 3), reads/s and a host-clock split of one `align` (packing,
copies, launches, collect); the kernel sum over the buckets
(`per_bucket_times`); and on the first bucket B4 and B5 by CUDA events
over back-to-back launches and by CUDA-graph replay (the launches
captured once, so the host's launch cost is left out), with ns per query
column of its longest pair (B4) and per diagonal its longest chain swept
(B5); then one JSON line of every number.

    python -m agatha_tpu_torch.probes.colsweep_cells --rows

prints instead B4 by graph replay on the first bucket of each cell with
the register instance forced to the K rows a lane it takes and to the
next instance up (K + 4), in turns (a, b, b, a), each ring held equal
to the default instance's.

Besides `host_split`, which reads the engine's spans
(`agatha_tpu_torch.trace`), it uses only the entry points every
revision of the port has (`AlignEngine`, `ops.colsweep.colsweep_shapes`,
`colsweep_sweep_cuda`, `colsweep_chain_cuda`, `probes.antidiag_cells`),
so that it can time another revision's package that has the trace in
the same call: run it by path with `PYTHONPATH=<other tree>` first on
the path.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from agatha_tpu_torch import AlignConfig, AlignEngine, make_workload
from agatha_tpu_torch.bench import device_line
from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.ops import colsweep as cs
from agatha_tpu_torch.probes.antidiag_cells import cuda_ms, wall_ms

CANON = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    slice_width=3, z_threshold=400, band_width=751)


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device ms of one fn() launch: reps launches captured in a CUDA
    graph, replayed `rounds` times, the best replay over reps."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()  # warm up on the capture stream
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    best = float("inf")
    for _ in range(rounds):
        ev[0].record()
        graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        best = min(best, ev[0].elapsed_time(ev[1]) / reps)
    return best


def host_split(engine, encoded, traceback: bool = False,
               counts: dict | None = None) -> dict:
    """Host-clock ms of one warm align(), split by the engine's own
    spans (`agatha_tpu_torch.trace`, on for the call); ``counts``, where
    given, is filled with the call's counters summed by name.

    Keys: validation ("validate"), bucketing and packing ("pack", each
    step of the bucket generator), the pinned copies ("copy", the
    "stage" spans), the kernel launches ("launch", every route's
    launcher; no synchronisation) and "collect" (the waits for the card
    and, with ``traceback``, for the CIGAR decode that began during
    dispatch, and the reorder); "other" is the rest of the wall.  On a CUDA device
    the card is synchronised before the call.  Tracing must be off on
    entry: the split drains the records.
    """
    from agatha_tpu_torch import trace

    if trace.on:
        raise RuntimeError("host_split drains the port's trace: call it "
                           "with tracing off")
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    trace.drain()
    trace.enable()
    try:
        t0 = time.perf_counter()
        engine.align(encoded, traceback=traceback)
        wall = time.perf_counter() - t0
    finally:
        trace.disable()
    spans, traced = trace.drain()
    if counts is not None:
        for (_call, name), n in traced.items():
            counts[name] = counts.get(name, 0) + n
    keys = {"validate": "validate", "pack": "pack", "stage": "copy",
            "launch": "launch", "collect": "collect"}
    split = dict.fromkeys(keys.values(), 0.0)
    for sp in spans:
        if sp.name in keys:
            split[keys[sp.name]] += (sp.end_ns - sp.start_ns) * 1e-6
    split["other"] = wall * 1e3 - sum(split.values())
    split["wall"] = wall * 1e3
    return split


def time_first_bucket(engine, encoded, cfg) -> dict:
    """B4 and B5 on the cell's first bucket, events and graph replay."""
    b = next(iter(engine.iter_buckets(encoded)))
    args = tuple(torch.from_numpy(a).cuda()
                 for a in (b.meta, b.tcodes, b.qfwd))
    shapes = cs.colsweep_shapes(b.meta, b.tcodes, b.qfwd, cfg)
    ring = cs.colsweep_sweep_cuda(*args, cfg, shapes)
    rows = cs.colsweep_chain_cuda(args[0], ring, cfg)
    out = {"gb": int(b.meta.shape[0]), "shapes": list(shapes),
           "max_qlen": int(b.meta[:, 0].max()),
           "max_diags": int(rows[:, 3].max())}
    sweep = lambda: cs.colsweep_sweep_cuda(*args, cfg, shapes)  # noqa: E731
    chain = lambda: cs.colsweep_chain_cuda(args[0], ring, cfg)  # noqa: E731
    out.update(b4_event_ms=cuda_ms(sweep, reps=20),
               b5_event_ms=cuda_ms(chain, reps=20),
               b4_graph_ms=graph_ms(sweep), b5_graph_ms=graph_ms(chain))
    out["b4_ns_per_column"] = out["b4_graph_ms"] * 1e6 / out["max_qlen"]
    out["b5_ns_per_diag"] = out["b5_graph_ms"] * 1e6 / out["max_diags"]
    print(f"  first bucket GB={out['gb']} (R, Q, d_pad)={tuple(shapes)} "
          f"max qlen {out['max_qlen']} max diags {out['max_diags']}: "
          f"B4 {out['b4_graph_ms']:.4f} ms graph / "
          f"{out['b4_event_ms']:.4f} events "
          f"({out['b4_ns_per_column']:.2f} ns per column), "
          f"B5 {out['b5_graph_ms']:.4f} ms graph / "
          f"{out['b5_event_ms']:.4f} events "
          f"({out['b5_ns_per_diag']:.2f} ns per diagonal)", flush=True)
    return out


def rows_turns(mean_len: int) -> dict:
    """B4 graph ms on the cell's first bucket with the register instance
    forced to its own K and to K + 4, in turns (a, b, b, a); every ring
    must equal the default instance's."""
    cfg = CANON
    encoded = make_workload(8192, mean_len, seed=1234, spread=0.05)
    engine = AlignEngine(cfg, device="cuda")
    b = next(iter(engine.iter_buckets(encoded)))
    args = tuple(torch.from_numpy(a).cuda()
                 for a in (b.meta, b.tcodes, b.qfwd))
    shapes = cs.colsweep_shapes(b.meta, b.tcodes, b.qfwd, cfg)
    ref = cs.colsweep_sweep_cuda(*args, cfg, shapes)
    default_launch = cs.sweep_launch
    sweep_k, wpb = default_launch(shapes)
    ks = (sweep_k, sweep_k + 4)
    times = {k: [] for k in ks}
    try:
        for k in ks + ks[::-1]:
            cs.sweep_launch = lambda _s, k=k: (k, wpb)
            ring = cs.colsweep_sweep_cuda(*args, cfg, shapes)
            if not torch.equal(ring, ref):
                raise AssertionError(f"K={k} ring differs at {mean_len} bp")
            times[k].append(graph_ms(
                lambda: cs.colsweep_sweep_cuda(*args, cfg, shapes)))
    finally:
        cs.sweep_launch = default_launch
    print(f"{mean_len} bp first bucket (R, Q, d_pad)={tuple(shapes)}, "
          f"default K {sweep_k}: " + ", ".join(
              f"K={k} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
              for k, ts in times.items()), flush=True)
    return {"shapes": list(shapes), "default_k": sweep_k,
            "b4_graph_ms": {str(k): ts for k, ts in times.items()}}


def short_cell(mean_len: int) -> dict:
    cfg = CANON
    encoded = make_workload(8192, mean_len, seed=1234, spread=0.05)
    engine = AlignEngine(cfg, device="cuda")
    engine.align(encoded)  # warm-up, builds
    _nvcc.launches.clear()
    res = engine.align(encoded)
    launches = [_nvcc.launches["antidiag.score"],
                _nvcc.launched("colsweep.sweep"),
                _nvcc.launches["colsweep.chain"]]
    wall, _res = wall_ms(engine, encoded)
    timed = engine.align(encoded, per_bucket_times=True)
    split = host_split(engine, encoded)
    out = {"buckets": res.n_buckets, "routes": sorted(set(res.routes)),
           "launches_antidiag_sweep_chain": launches, "wall_ms": wall,
           "reads_per_s": len(encoded) / wall * 1e3,
           "kernel_sum_ms": sum(timed.bucket_ms),
           "bucket_ms": timed.bucket_ms, "host_split_ms": split}
    print(f"{mean_len} bp: {res.n_buckets} buckets, routes "
          f"{out['routes']}, launches antidiag/sweep/chain {launches}; "
          f"wall {wall:.3f} ms, reads/s {out['reads_per_s']:.1f}, kernel "
          f"sum {out['kernel_sum_ms']:.4f} ms: "
          + " ".join(f"{m:.4f}" for m in timed.bucket_ms), flush=True)
    print("  host split of one align(), ms: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    out.update(time_first_bucket(engine, encoded, cfg))
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("colsweep_cells needs a CUDA device")
    print(device_line(), flush=True)
    print(f"package {cs.__file__}", flush=True)
    cs.LIB.load()
    regs = [line.strip() for line in cs.LIB.log.splitlines()
            if "registers" in line or "spill" in line]
    out = {"device": device_line(), "ptxas": regs}
    if argv == ["--rows"]:
        out["rows150"] = rows_turns(150)
        out["rows600"] = rows_turns(600)
        print(json.dumps(out))
        return 0
    out["short150"] = short_cell(150)
    out["short600"] = short_cell(600)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
