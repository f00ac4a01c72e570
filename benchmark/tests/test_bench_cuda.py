"""The reference and a run on the card, at a tiny size.  Marked `cuda`;
each test skips without a card.

    python3 -m pytest -m cuda benchmark/tests/test_bench_cuda.py -q
"""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, reference
from benchmark.tests.test_bench_faults import tiny
from benchmark.tests.test_bench_reference import CASES, pairs

pytestmark = pytest.mark.cuda


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.parametrize("sc,seed,n,lens,opts", CASES)
def test_the_reference_reads_the_same_on_the_card(sc, seed, n, lens, opts):
    need_card()
    qs, ts = pairs(seed, n, *lens, **opts)
    for bits in (None, 8):
        a = reference.align(qs, ts, sc, bits=bits)
        b = reference.align(qs, ts, sc, device="cuda", bits=bits)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cell_name", ["agatha_sh-long10k",
                                       "agatha_sh-long10k_cigar"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_on_the_card(cell_name, trace):
    need_card()
    cell = tiny(cell_name, pairs_per_batch=64, mean_len=2000)
    out = harness.run(cell.name, 2**31 + 11, 1.0, trace,
                      t_process=time.perf_counter(), cell=cell)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
        assert any(k.startswith("device_idle_pct") for k in out["metrics"])
