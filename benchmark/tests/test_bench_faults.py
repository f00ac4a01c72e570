"""A run with its timed path broken underneath comes out not correct,
and the control comes out not correct at a size a test can hold.

These runs skip the look for a card: the engine runs its plain versions
on the CPU, at a tiny size, through the rest of a run (pool, warm-up,
window, check, result line).
"""

import copy
import dataclasses
import time

import numpy as np
import pytest

from benchmark import check, generator, harness, spec


def tiny(cell_name, **traffic):
    cell = spec.load_cell(cell_name)
    cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config),
                               traffic=dict(cell.traffic))
    cell.traffic.update(dict(dict(pairs_per_batch=8, mean_len=150,
                                  check_pairs=64, check_candidates=8),
                             **traffic))
    cell.config["pool_batches"] = 2
    return cell


def run(cell, fault=None, seed=2**31 + 99, seconds=0.2):
    return harness.run(cell.name, seed, seconds, False,
                       t_process=time.perf_counter(), device="cpu",
                       cell=cell, fault=fault)


class Broken:
    """The engine with one fault planted where the answers come out."""

    def __init__(self, engine, kind):
        self.engine, self.kind, self.last = engine, kind, None

    def encode_pairs(self, pairs):
        return self.engine.encode_pairs(pairs)

    def align(self, enc, **kw):
        res = self.engine.align(enc, **kw)
        if self.kind == "stale":
            # a step that returns its state unchanged: the last answers
            prev, self.last = self.last, copy.deepcopy(res)
            return prev if prev is not None else res
        if self.kind == "half":
            # half of the batch left out, the mean taken over the rest
            h = len(res.scores) // 2
            for f in ("scores", "query_ends", "target_ends", "diags"):
                a = getattr(res, f)
                a[h:] = int(a[:h].mean())
        elif self.kind == "answer":
            res.scores[0] += 1
        elif self.kind == "cigar":
            c = res.cigars[0]
            i = c.index("M")
            res.cigars[0] = c[:i] + "I" + c[i + 1:]
        return res


@pytest.mark.parametrize("cell_name", ["agatha_sh-long10k",
                                       "agatha_sh-long10k_cigar"])
def test_a_sound_run_is_correct(cell_name):
    out = run(tiny(cell_name))
    assert out["correct"] is True
    assert out["failed"] == 0
    assert list(out)[-1] == "checks"
    rate = [v for k, v in out["metrics"].items() if k.startswith("gcups")]
    assert len(rate) == 1 and rate[0]["value"] > 0


@pytest.mark.parametrize("kind", ["stale", "half", "answer"])
def test_a_broken_score_path_is_not_correct(kind):
    # the stale answers show from the second batch on
    out = run(tiny("agatha_sh-long10k"), lambda e: Broken(e, kind),
              seconds=0.2 if kind != "stale" else 2.0)
    assert out["attempted"] >= 16 or kind != "stale"
    assert out["correct"] is False
    assert out["checks"]["pairs_wrong"]["value"] > 0


def test_an_altered_cigar_is_not_correct():
    out = run(tiny("agatha_sh-long10k_cigar"), lambda e: Broken(e, "cigar"))
    assert out["correct"] is False
    assert out["checks"]["cigars_wrong"]["value"] > 0
    assert out["checks"]["pairs_wrong"]["value"] == 0


def _control(cell, pool, seed):
    keeper = check.Keeper(pool, seed, 64)
    n = len(pool[0][0])
    for k in range(len(pool)):
        keeper.batches.append((k, np.zeros((n, 4), np.int64), {}))
    sample = check.draw_sample(keeper, seed, 64)
    return check.control_reading(keeper, sample, cell.config, "cpu")


def test_the_control_fails_agatha_sh():
    cell = tiny("agatha_sh-long10k", mean_len=300)
    pool = generator.make_pool(cell.traffic, 2, 5)
    got = _control(cell, pool, 5)
    assert got["pairs_wrong"][0] == got["checked"] > 0

