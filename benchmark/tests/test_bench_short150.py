"""The short-read cell `agatha_sh-short150`: a tiny run through the
harness on the CPU (the port's plain versions) and on the card, and the
reader of its `launch_ms` metric on a made-up trace.

    python3 -m pytest -m cuda benchmark/tests/test_bench_short150.py -q
"""

import time

import pytest
import torch

from benchmark import spec
from benchmark.tests.test_bench_faults import run, tiny
from benchmark.tests.test_bench_trace import trace as made_up

CELL = "agatha_sh-short150"
LAYER = ("encode_ms.short150", "pack_ms.short150", "launch_ms.short150",
         "pairs_per_bucket.short150", "score_roofline.short150",
         "device_idle_pct.short150")


def test_the_cell_reads_the_short_read_traffic():
    c = spec.load_cell(CELL)
    assert c.traffic["pairs_per_batch"] == c.config["engine"][
        "aligns_per_batch"] == 8192
    assert (c.traffic["mean_len"], c.traffic["spread"]) == (150, 0.05)
    assert c.traffic["traceback"] is False
    assert {m["name"] for m in c.end_to_end} == {
        "gcups", "batch_ms_p90", "peak_mem_gib", "setup_s"}
    assert [m["name"] for m in c.per_layer] == list(LAYER)


def test_a_tiny_run_on_the_cpu_is_correct():
    out = run(tiny(CELL, pairs_per_batch=64))
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["pairs_wrong"]["of"] > 0
    assert set(out["metrics"]) == {"gcups", "batch_ms_p90", "peak_mem_gib",
                                   "setup_s"}
    assert out["metrics"]["gcups"]["value"] > 0


def test_launch_ms_reads_the_launch_span():
    read = spec.reader("launch_ms.short150")
    t = made_up(False)
    assert read(t) is None  # no launch span in this trace
    t["spans"]["launch"] = [0.004, 0.002]
    assert read(t) == pytest.approx(3.0)
    t["spans"]["launch"] = []
    assert read(t) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from benchmark import harness

    cell = tiny(CELL, pairs_per_batch=1024)
    out = harness.run(cell.name, 2**31 + 19, 1.0, trace,
                      t_process=time.perf_counter(), cell=cell)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert set(out["metrics"]) == set(LAYER)
        assert out["metrics"]["pairs_per_bucket.short150"]["value"] == 128
        assert 0 < out["metrics"]["score_roofline.short150"]["value"] < 100
    else:
        assert out["metrics"]["gcups"]["value"] > 0
