"""Short-read seed extension through the port's normal path on the CPU.

Pairs of 150 bp +- 5% drawn by the benchmark's generator with the
`short150` traffic profile (2.1% divergence, nearly all substitutions),
and hand-made pairs at the edges of that deployment: the length
extremes, N bases in the query, a target shorter than one 8-base chunk.
`AlignEngine(device="cpu")` (`encode_pairs` then `align`, as the
benchmark calls them) must equal the benchmark's plain reference
exactly, every bucket must take the column sweep (B4/B5's plain
versions here), and at this divergence Z-drop must not fire: the
diagonals swept equal those of a run whose Z-drop threshold no score
can reach.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from agatha_tpu_torch import AlignConfig, AlignEngine, EngineConfig, SeqPair
from benchmark import generator, reference

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "traffic", "short150.json")) as f:
    PROFILE = json.load(f)
# the deployment's flags (benchmark/configs/agatha_human150.json)
CFG = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                  slice_width=3, z_threshold=400, band_width=751)
# a threshold no drop of a 160 bp alignment reaches (a score moves at
# most 1 + 4 a base), still int16-safe
NO_ZDROP = dataclasses.replace(CFG, z_threshold=20000)
ENGINE = EngineConfig(aligns_per_batch=8192, cpu_threads=1,
                      target_buckets=16, use_all_devices=False)


def drawn(seed, n):
    """n pairs of the short150 profile, from the seed."""
    traffic = dict(PROFILE, pairs_per_batch=n)
    (qs, ts), = generator.make_pool(traffic, 1, seed)
    return qs, ts


def mutated(rng, q, sub=0.02):
    t = np.array(list(q))
    hit = rng.random(len(t)) < sub
    t[hit] = rng.choice(list("ACGT"), int(hit.sum()))
    return "".join(t)


def bases(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def edge_pairs(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "length_extremes":
        qs = [bases(rng, n) for n in (142, 157, 142, 157)]
        ts = [mutated(rng, qs[0]), mutated(rng, qs[1]),
              mutated(rng, qs[2])[:-5], mutated(rng, qs[3]) + "ACG"]
    elif kind == "n_in_query":
        ts = [bases(rng, n) for n in (150, 147, 155, 142)]
        qs = []
        for t, at in zip(ts, (0, 40, 75, 141)):
            q = list(mutated(rng, t))
            q[at:at + 3] = "NNN"
            qs.append("".join(q)[:len(t)])
    elif kind == "target_under_8":
        qs = [bases(rng, n) for n in (150, 142, 157, 150)]
        ts = [qs[0][:5], qs[1][:1], "ACGTACG", qs[3][:7]]
    return qs, ts


def check(qs, ts):
    engine = AlignEngine(CFG, ENGINE, device="cpu")
    pairs = [SeqPair(q, t, 0, 0) for q, t in zip(qs, ts)]
    res = engine.align(engine.encode_pairs(pairs))
    assert res.routes and set(res.routes) == {"colsweep"}
    ref = reference.align(qs, ts, reference.Scoring(
        **dataclasses.asdict(CFG)))
    for field, key in (("scores", "score"), ("query_ends", "query_end"),
                       ("target_ends", "target_end"), ("diags", "diags")):
        np.testing.assert_array_equal(getattr(res, field), ref[key],
                                      err_msg=field)
    far = AlignEngine(NO_ZDROP, ENGINE, device="cpu")
    wide = far.align(far.encode_pairs(pairs))
    np.testing.assert_array_equal(res.diags, wide.diags)
    np.testing.assert_array_equal(res.scores, wide.scores)
    return res


@pytest.mark.parametrize("seed", [7, 2**31 + 5, 90210, 2**32 + 2**20])
def test_drawn_short_reads_equal_the_reference(seed):
    qs, ts = drawn(seed, 48)
    lens = np.array([len(q) for q in qs])
    assert 142 <= lens.min() and lens.max() <= 157
    res = check(qs, ts)
    assert (res.scores > 0).all()


@pytest.mark.parametrize("kind", ["length_extremes", "n_in_query",
                                  "target_under_8"])
def test_edge_pairs_equal_the_reference(kind):
    check(*edge_pairs(kind))
