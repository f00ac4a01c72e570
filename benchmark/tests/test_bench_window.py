"""The window's arithmetic: a rate over the whole wall, a tail over every
batch, so that one stalled batch moves both."""

import time
import types

import numpy as np
import pytest

from benchmark import harness


class SleepyEngine:
    """Stands in for the engine: each align takes the next delay."""

    def __init__(self, delays):
        self.delays = list(delays)
        self.calls = 0

    def encode_pairs(self, pairs):
        return pairs

    def align(self, enc, traceback=False):
        time.sleep(self.delays[min(self.calls, len(self.delays) - 1)])
        self.calls += 1
        z = np.zeros(len(enc), np.int64)
        return types.SimpleNamespace(scores=z, query_ends=z, target_ends=z,
                                     diags=z, cigars=None, n_buckets=1)


class Sink:
    def __init__(self):
        self.kept = []

    def keep(self, k, pi, res):
        self.kept.append((k, pi))


def test_window_runs_past_the_deadline_to_the_batch_in_flight():
    eng = SleepyEngine([0.03])
    sink = Sink()
    lat, wall, extra = harness.window(eng, [[1, 2], [3]], 0.1, False, sink)
    assert wall >= 0.1
    assert len(lat) == len(extra) == len(sink.kept) == eng.calls
    assert abs(sum(lat) - wall) < 0.01 * len(lat) + 0.005
    # the pool is cycled: no two consecutive batches are the same input
    assert [pi for _k, pi in sink.kept][:3] == [0, 1, 0]


def test_one_stalled_batch_moves_the_rate_and_the_tail():
    cells = [1_000_000_000] * 8
    even = [0.1] * 8
    stall = [0.1] * 7 + [0.5]
    a = harness.end_to_end(cells, even, sum(even), 0, 1.0)
    b = harness.end_to_end(cells, stall, sum(stall), 0, 1.0)
    assert a["gcups"] == pytest.approx(8 / 0.8)
    assert b["gcups"] == pytest.approx(8 / 1.2)
    assert a["batch_ms_p90"] == pytest.approx(100.0)
    assert b["batch_ms_p90"] > 200.0
    # the 90th percentile of all batches, not of a trimmed set
    assert harness.p90([1.0] * 9 + [11.0]) == pytest.approx(2.0)
    assert harness.end_to_end(cells, even, 0.8, 2**30, 3.0)[
        "peak_mem_gib"] == 1.0


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "agatha_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib"]
