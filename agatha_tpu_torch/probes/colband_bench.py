"""Timing harness around the production banded column-sweep kernel.

PyTorch / CUDA counterpart of `scripts/_colband_bench.py` (`stage_bucket`,
`make_call`, `rep_chain`, `slope_ns_per_col`): stage one bucket's device
tensors once (copies out of the loop), launch the production kernel
(`ops.colband.colband_cuda`, `csrc/colband.cu`) `reps` and `reps // 2`
times back to back between CUDA events, and report ns per column from
the slope between the two counts, which cancels the fixed ends; the best
of `rounds`.  Launches on one CUDA stream run in order and are neither
fused nor hoisted, so the repetitions need no data dependency between
them (the original chained them through an input row the kernel never
reads).  The original counted the columns of its 128-pair programs,
programs x Qpad.  Here a pair is a block and its sweep stops at its own
query length, so a launch is as long as its longest pair's sweep and the
count is ceil(GB / 128) x the longest query (at most Qpad): ns per
column is the time one column of a 128-pair group takes.

    python -m agatha_tpu_torch.probes.colband_bench [n_pairs mean_len band]

stages the fewest-column bucket of `make_workload(n_pairs, mean_len,
seed=1234)` as the engine with colband on would build it, and prints the
card's name and power limit, then for each B7 instance that takes the
bucket's window (R rows a thread) ns per column, ms per launch and the
kernel's clock64 split of a column (`column_split`), then each B7
instance's ptxas registers and spills where this process built it.
"""

from __future__ import annotations

import re
import sys

import numpy as np
import torch

from agatha_tpu_torch.config import AlignConfig
from agatha_tpu_torch.ops import colband as cb
from agatha_tpu_torch.probes.antidiag_cells import cuda_ms


def stage_bucket(meta, tcodes, qfwd, cfg: AlignConfig, device="cuda"):
    """Device-stage one bucket's host wire for the kernel.

    Returns (scalars, tcodes, qfwd, shapes): the (8, GB) chain scalars
    and the nibble wire as tensors on `device`, and `colband_shapes`.
    """
    shapes = cb.colband_shapes(meta, cfg)
    scalars = cb.chain_scalars(meta, cfg)
    dev = torch.device(device)
    return (*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (scalars, tcodes, qfwd)), shapes)


def make_call(cfg: AlignConfig, shapes, rows=None):
    """The production kernel launch at `shapes`, of the instance of
    `rows` rows a thread (the engine's when None)."""
    def call(scalars, tcodes, qfwd):
        return cb.colband_cuda(scalars, tcodes, qfwd, cfg, shapes,
                               rows=rows)
    return call


def rep_chain(call):
    """n launches back to back on the current stream, timed by CUDA
    events; returns ms."""
    def go(scalars, tcodes, qfwd, n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call(scalars, tcodes, qfwd)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    return go


def swept_columns(scalars, shapes) -> int:
    """Columns of a launch as the slope counts them: 128-pair groups
    times the longest query's columns, at most Qpad (an upper count: a
    pair whose chain ends early stops sooner)."""
    gb = scalars.shape[1]
    return -(-gb // 128) * int(scalars[0].clamp(max=shapes[2]).max())


def slope_ns_per_col(go, scalars, tcodes, qfwd, reps, cols, rounds=4):
    """(ns per column, ms per launch): best-of-`rounds` slope between
    reps and reps // 2 launches (the first call builds the kernel)."""
    go(scalars, tcodes, qfwd, 1)

    def timeit(n):
        return min(go(scalars, tcodes, qfwd, n) for _ in range(rounds))

    t_full = timeit(reps)
    t_half = timeit(reps // 2)
    per_launch = (t_full - t_half) / (reps - reps // 2)
    return per_launch * 1e6 / cols, per_launch


def bench_bucket(meta, tcodes, qfwd, cfg, reps=8, rounds=4, rows=None):
    """ns per column and ms per launch of one host bucket on the card
    (of the instance `rows`, as `make_call`)."""
    scalars, tc, qf, shapes = stage_bucket(meta, tcodes, qfwd, cfg)
    go = rep_chain(make_call(cfg, shapes, rows))
    cols = swept_columns(scalars, shapes)
    ns_col, ms = slope_ns_per_col(go, scalars, tc, qf, reps, cols, rounds)
    return {"ns_per_col": ns_col, "ms": ms, "cols": cols, "shapes": shapes}


# The parts of a column that the kernel's split instances time
# (csrc/colband.cu, colband_kernel<R, kSplit>), in their slot order.
# The chain warp passes the same barriers; its "pass 2 + ring" is its
# chain rounds.
SPLIT_PARTS = ("barrier A", "pass 1", "warp scan",
               "barrier B + warp totals", "pass 2 + ring", "group steps")


def instances(RW: int) -> list[int]:
    """Rows a thread of every B7 instance that takes a window of RW
    rows."""
    return [r for r in cb.COLBAND_ROWS
            if cb.block_threads(RW, r) <= cb.max_threads(r)]


def raw_launch(args, out, cfg: AlignConfig, shapes, rows: int,
               split) -> None:
    """The split instance of `rows` rows a thread (csrc/colband.cu,
    colband_kernel<R, true>) on the staged (scalars, tcodes, qfwd) into
    `out`, its clock64 parts into `split`; counted as
    probe.colband_split.r<rows>."""
    scalars, tc, qf = args
    RW, _r8, Qpad, _g, _ga, _gb, _t, LEAD, WMAX = shapes
    cb.LIB.launch(
        "agatha_colband", f"probe.colband_split.r{rows}",
        scalars.data_ptr(), tc.data_ptr(), qf.data_ptr(), out.data_ptr(),
        scalars.shape[1], 2 * tc.shape[1], 2 * qf.shape[1], RW, Qpad, LEAD,
        WMAX, cfg.match, cfg.mismatch, cfg.gap_oe, cfg.gap_extend,
        cfg.slice_width, cfg.z_threshold, cfg.band_width, rows, split,
        on=scalars)


def kernel_registers(log: str) -> dict:
    """{colband_kernel instance: its ptxas registers and spill line} from
    a build's report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"colband_kernelILi(\d)ELb(\d)", line)
        if "Compiling entry" in line or "Function properties" in line:
            name = (f"R={m.group(1)}{' split' if m.group(2) == '1' else ''}"
                    if m else None)
        elif name and ("spill" in line or "registers" in line):
            out[name] = (out.get(name, "") + " " + line.split(":")[-1]
                         .strip()).strip()
    return out


def column_split(meta, tcodes, qfwd, cfg: AlignConfig, rows=None) -> dict:
    """clock64 cycles per column of each part, from the split instance of
    `rows` rows a thread (`colband_rows(RW)` when None) on one bucket:
    for the block of the bucket's longest query, lane 0 of each row warp
    and of the chain warp.  Also the split instance's ms against the
    production launch's (what the timing costs)."""
    scalars, tc, qf, shapes = stage_bucket(meta, tcodes, qfwd, cfg)
    gb = scalars.shape[1]
    RW = shapes[0]
    if rows is None:
        rows = cb.colband_rows(RW)
    warps = cb.block_threads(RW, rows) // 32
    split = torch.zeros((gb, warps, 8), dtype=torch.int64, device="cuda")
    out = torch.empty((gb, 4), dtype=torch.int32, device="cuda")

    def run():
        raw_launch((scalars, tc, qf), out, cfg, shapes, rows,
                   split.data_ptr())

    def prod():
        return cb.colband_cuda(scalars, tc, qf, cfg, shapes, rows=rows)

    split_ms = cuda_ms(run, reps=3)
    if not torch.equal(out, prod()):
        raise AssertionError("the split instance's output differs")
    ms = cuda_ms(prod, reps=3)
    blk = int(torch.argmax(scalars[0]))
    s = split[blk].cpu().numpy()
    cols = max(int(s[0, 6]), 1)
    per = {"row warps": [(s[w, :6] / cols).tolist()
                         for w in range(warps - 1)],
           "chain warp": (s[warps - 1, :6] / cols).tolist()}
    return {"parts": SPLIT_PARTS, "columns": cols, "block": blk,
            "rows": rows,
            "cycles_per_column": per, "split_ms": split_ms, "ms": ms}


def print_split(r: dict) -> None:
    rows = r["cycles_per_column"]["row warps"]
    chain = r["cycles_per_column"]["chain warp"]
    print(f"clock64 split of one column, R={r['rows']} (block "
          f"{r['block']}, {r['columns']} columns; split instance "
          f"{r['split_ms']:.3f} ms, production {r['ms']:.3f} ms), cycles "
          f"per column:")
    sums = [sum(p) for p in rows]
    # the row warps' mean and their slowest, then the chain warp
    mean = [sum(p[i] for p in rows) / len(rows) for i in range(6)]
    slow = rows[max(range(len(rows)), key=lambda w: sums[w])]
    for label, parts in (("row warps, mean", mean),
                         ("slowest row warp", slow), ("chain warp", chain)):
        print(f"  {label}: " + ", ".join(
            f"{n} {c:.1f}" for n, c in zip(r["parts"], parts))
            + f"; sum {sum(parts):.1f}")


def main(argv: list[str] | None = None) -> int:
    from agatha_tpu_torch import AlignEngine, EngineConfig, make_workload
    from agatha_tpu_torch.bench import device_line

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("the harness needs a CUDA device")
    n_pairs = int(argv[0]) if len(argv) > 0 else 1024
    mean_len = int(argv[1]) if len(argv) > 1 else 10000
    band = int(argv[2]) if len(argv) > 2 else 751
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=band)
    engine = AlignEngine(cfg, EngineConfig(colband=True), device="cuda")
    encoded = make_workload(n_pairs, mean_len, seed=1234)
    b = min(engine.iter_buckets(encoded),
            key=lambda b: int(b.meta[:, 0].sum()))
    print(f"# device={device_line()}")
    RW = cb.colband_shapes(b.meta, cfg)[0]
    for rows in instances(RW):
        r = bench_bucket(b.meta, b.tcodes, b.qfwd, cfg, rows=rows)
        taken = " (the engine takes it)" if rows == cb.colband_rows(RW) else ""
        print(f"colband kernel, R={rows}{taken}: "
              f"GB={b.meta.shape[0]} shapes={r['shapes']} columns "
              f"{r['cols']}: {r['ms']:.4f} ms per launch, "
              f"{r['ns_per_col']:.3f} ns per column")
        print_split(column_split(b.meta, b.tcodes, b.qfwd, cfg, rows))
    for name, regs in sorted(kernel_registers(cb.LIB.log).items()):
        print(f"ptxas {name}: {regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
