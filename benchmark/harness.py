"""One run of one cell: data from the seed, set-up, the measured window,
the check, and the result line.

The window is a closed loop with one batch in flight, as a mapper calls
a GASAL2-style batch API (the port's `cli.py` does the same per batch):
`AlignEngine.encode_pairs` on the batch's strings, then
`AlignEngine.align`, which returns after the copy back to the host.  The
batches cycle a pool of distinct batches made from the seed, so no two
consecutive batches are the same input.  A batch's latency is the host
clock from the `encode_pairs` call to `align`'s return; the rate counts
the in-band cells of every batch completed, over the window's whole
wall, which ends when the batch running at the deadline returns.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import check, generator, roofline, spec, tracing

FORBIDDEN = {"jax", "jaxlib", "flax", "agatha_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the other)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def smi(fields: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def make_engine(config: dict, device: str):
    from agatha_tpu_torch import AlignConfig, AlignEngine, EngineConfig

    return AlignEngine(AlignConfig(**config["align"]),
                       EngineConfig(**config["engine"]), device=device)


def seqpairs(batch):
    from agatha_tpu_torch import SeqPair

    return [SeqPair(q, t, 0, 0) for q, t in zip(*batch)]


def p90(values) -> float:
    """The 90th percentile of all values, interpolated
    (`statistics.quantiles` with n=10, inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def end_to_end(cells, latencies, wall, peak_bytes, setup_s) -> dict:
    """The end-to-end metrics of a window: the in-band cells of every
    completed batch over the whole wall; the 90th percentile of every
    batch's latency; the window's peak allocated memory; set-up."""
    return {
        "gcups": sum(cells) / wall / 1e9,
        "batch_ms_p90": p90([x * 1e3 for x in latencies]),
        "peak_mem_gib": peak_bytes / 2**30,
        "setup_s": setup_s,
    }


class Counts:
    """In-band cells of each completed batch, counted after the window;
    a batch repeated from the pool with the same answers is counted
    once."""

    def __init__(self, pool, band_width: int):
        self.bw = band_width
        self.lens = [(np.array([len(q) for q in b[0]]),
                      np.array([len(t) for t in b[1]])) for b in pool]
        self._cells: dict = {}

    def cells(self, pool_index: int, diags: np.ndarray) -> int:
        key = (pool_index, diags.tobytes())
        if key not in self._cells:
            ql, rl = self.lens[pool_index]
            self._cells[key] = roofline.banded_cells(ql, rl, diags, self.bw)
        return self._cells[key]


def moves(cigars) -> int:
    """Steps of the paths: every run length of every CIGAR."""
    return sum(int(n) for c in cigars for n in re.findall(r"\d+", c))


def window(engine, pool_pairs, seconds: float, traceback: bool, keeper,
           spans=None):
    """The measured loop; returns (latencies, wall, what each completed
    batch left for the per-layer readers)."""
    lat = []
    extra = []
    t_start = time.perf_counter()
    k = 0
    while True:
        pi = k % len(pool_pairs)
        t0 = time.perf_counter()
        with (spans.span("encode") if spans is not None
              else contextlib.nullcontext()):
            enc = engine.encode_pairs(pool_pairs[pi])
        res = engine.align(enc, traceback=traceback)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        keeper.keep(k, pi, res)
        extra.append((res.n_buckets,
                      res.cigars if traceback and k < len(pool_pairs)
                      else None))
        if spans is not None:
            spans.end_batch()
        k += 1
        if t1 - t_start >= seconds:
            return lat, t1 - t_start, extra


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_process: float, device: str = "cuda", root: str = spec.ROOT,
        cell: spec.Cell | None = None, fault=None) -> dict:
    """One run; returns the result line's object (and prints the lines
    a run prints on stderr).  ``fault`` (tests only) wraps the engine."""
    cell = cell or spec.load_cell(cell_name, root)
    cfg, tr = cell.config, cell.traffic
    traceback = bool(tr["traceback"])
    cuda = device == "cuda"
    if cuda:
        log(f"# card: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")

    t_pool = time.perf_counter()
    pool = generator.make_pool(tr, int(cfg["pool_batches"]), seed, device)
    pool_pairs = [seqpairs(b) for b in pool]
    t_engine = time.perf_counter()
    engine = make_engine(cfg, device)
    if fault is not None:
        engine = fault(engine)
    keeper = check.Keeper(pool, seed, int(tr["check_candidates"]))
    # warm-up: the cell's first batch builds or loads the kernels its
    # route uses, and the native encoder
    warm = engine.align(engine.encode_pairs(pool_pairs[0]),
                        traceback=traceback)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"# setup_s {setup_s:.4f}: start {t_pool - t_process:.3f}, pool "
        f"{t_engine - t_pool:.3f} ({len(pool)} x {len(pool[0][0])} pairs), "
        f"engine and warm-up {time.perf_counter() - t_engine:.3f}; buckets "
        f"{warm.n_buckets}, routes {sorted(set(warm.routes or []))}")
    del warm

    spans = prof = None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        spans = tracing.Spans()
        undo = spans.install(engine)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA] if cuda else [
            torch.profiler.ProfilerActivity.CPU])
        prof.__enter__()
        with torch.profiler.record_function("bench.window"):
            lat, wall, extra = window(engine, pool_pairs, seconds,
                                      traceback, keeper, spans)
        prof.__exit__(None, None, None)
        undo()
    else:
        lat, wall, extra = window(engine, pool_pairs, seconds, traceback,
                                  keeper)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_batches = len(lat)
    n_pairs = len(pool[0][0])
    q = statistics.quantiles([x * 1e3 for x in lat], n=4) if n_batches > 1 \
        else [lat[0] * 1e3] * 3
    log(f"# window {wall:.4f} s, {n_batches} batches, batch ms quartiles "
        f"{q[0]:.2f} {q[1]:.2f} {q[2]:.2f}, max {max(lat) * 1e3:.2f}")
    if cuda:
        log("# after the window, nvidia-smi name, clocks.sm, "
            "clocks.max.sm, power.draw, power.limit: "
            + smi("name,clocks.sm,clocks.max.sm,power.draw,power.limit"))

    # the program's state goes before the reference runs
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    counts = Counts(pool, cfg["align"]["band_width"])
    cells = [counts.cells(pi, f[:, 3]) for pi, f, _c in keeper.batches]

    trace_data = None
    if trace:
        trace_data = _trace_data(prof, cuda, spans, keeper, extra, counts,
                                 cells, traceback, wall)

    t_ref = time.perf_counter()
    sample = check.draw_sample(keeper, seed, int(tr["check_pairs"]))
    checked = check.compare(keeper, sample, cfg, device,
                            traceback=traceback)
    fields = np.concatenate([f for _pi, f, _c in keeper.batches])
    log(f"# reference: {checked['checked']} pairs in "
        f"{time.perf_counter() - t_ref:.1f} s; answers: score "
        f"{fields[:, 0].min()}-{fields[:, 0].max()}, target end max "
        f"{fields[:, 2].max()}, diagonals {fields[:, 3].min()}-"
        f"{fields[:, 3].max()}; longest target "
        f"{max(len(t) for b in pool for t in b[1])}")
    numbers = {k: v for k, v in checked.items() if k != "checked"}
    wrong_pairs = numbers["pairs_wrong"][0]
    correct = all(v <= lim for v, lim in numbers.values())

    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded modules of JAX or the JAX package: "
                         f"{', '.join(found)}")

    metrics = {}
    if not trace:
        values = end_to_end(cells, lat, wall, window_peak, setup_s)
        log("# end to end: " + ", ".join(f"{k} {v}" for k, v in
                                         values.items()))
        for m in cell.end_to_end:
            # a metric split by cells ("gcups.cigar") is its quantity's
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.reader(m["name"])(trace_data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    out = {"correct": bool(correct), "attempted": n_batches * n_pairs,
           "failed": int(wrong_pairs), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trace_data["device"]["busy_s"]
        dev["window_s"] = trace_data["device"]["window_s"]
        out["breakdown"] = {
            "device_ops": trace_data["device"]["device_ops"],
            "idle_gaps": trace_data["device"]["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim, "of": checked["checked"]}
                     for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"check {k} {v} limit {lim} (of {checked['checked']} pairs)")
    return out


def _trace_data(prof, cuda, spans, keeper, extra, counts, cells,
                traceback, wall) -> dict:
    """What the per-layer readers read."""
    device = {"kernel_s": 0.0, "busy_s": 0.0, "window_s": wall,
              "kernel_busy_s": 0.0, "device_ops": [], "idle_gaps": [],
              "source": "none"}
    if cuda:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            device = tracing.read_chrome_trace(path)
            device["source"] = "profiler"
        finally:
            os.unlink(path)
        if device["kernel_s"] <= 0:
            raise SystemExit("the profiler's trace holds no kernel time "
                             "in the window: no device metric to read")
    least = 0.0
    moves_by_pool: dict[int, int] = {}
    for k, (pi, f, _c) in enumerate(keeper.batches):
        ql, rl = counts.lens[pi]
        if traceback:
            if pi not in moves_by_pool:
                moves_by_pool[pi] = moves(extra[k][1] or [])
            least += roofline.traceback_least(cells[k], moves_by_pool[pi],
                                              ql, rl)
        else:
            least += roofline.score_least(cells[k], ql, rl)
    return {
        "traceback": traceback,
        "spans": spans.per_batch,
        "pairs": [len(f) for _pi, f, _c in keeper.batches],
        "n_buckets": [e[0] for e in extra],
        "least_s": least,
        "device": device,
    }


def main(argv=None, *, t_process: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, torch sees "
            f"{torch.cuda.device_count()}")
        return 2
    out = run(a.workload, a.seed, a.seconds, bool(a.trace),
              t_process=t_process, cell=cell)
    print(json.dumps(out), flush=True)
    return 0
