"""The traffic generator: seeded, and shaped as its traffic file says."""

import numpy as np
import torch

from benchmark import generator

LONG = dict(pairs_per_batch=64, mean_len=2000, spread=0.5, divergence=0.10,
            substitution_share=0.5, insertion_share=0.25,
            deletion_share=0.25, indel_len=[1, 3])


def test_same_seed_same_batches_other_seed_other():
    a = generator.make_pool(LONG, 2, 2**31 + 5)
    b = generator.make_pool(LONG, 2, 2**31 + 5)
    c = generator.make_pool(LONG, 2, 2**31 + 6)
    assert a == b
    assert a[0] != a[1]
    assert a[0][0] != c[0][0] and a[0][1] != c[0][1]


def test_every_batch_has_the_same_lengths_in_another_order():
    pool = generator.make_pool(LONG, 3, 11)
    other = generator.make_pool(LONG, 1, 12)
    want = sorted(generator.lengths(LONG).tolist())
    assert 1000 <= min(want) < 1050 and 2950 < max(want) < 3000
    orders = []
    for q, _t in pool + other:
        got = [len(s) for s in q]
        assert sorted(got) == want
        orders.append(got)
    assert orders[0] != orders[1] != orders[3]


def _mean_rate(traffic, seed=3):
    gen = torch.Generator().manual_seed(seed)
    q, t = generator.make_batch(traffic, gen)
    return q, t


def test_substitutions_follow_the_file():
    tr = dict(LONG, divergence=0.2, substitution_share=1.0,
              insertion_share=0.0, deletion_share=0.0)
    q, t = _mean_rate(tr)
    assert [len(x) for x in q] == [len(x) for x in t]
    a = np.frombuffer("".join(q).encode(), np.uint8)
    b = np.frombuffer("".join(t).encode(), np.uint8)
    # a substituted base is a random base: 3 in 4 differ
    assert abs((a != b).mean() - 0.2 * 0.75) < 0.01
    assert set(np.unique(b).tobytes()) <= set(b"ACGT")


def test_insertions_and_deletions_follow_the_file():
    ins = dict(LONG, divergence=0.1, substitution_share=0.0,
               insertion_share=1.0, deletion_share=0.0)
    q, t = _mean_rate(ins)
    grow = sum(map(len, t)) / sum(map(len, q)) - 1
    assert abs(grow - 0.1 * 2.0) < 0.01          # 1-3 bases, mean 2
    dele = dict(ins, insertion_share=0.0, deletion_share=1.0)
    q, t = _mean_rate(dele)
    shrink = 1 - sum(map(len, t)) / sum(map(len, q))
    # runs of mean 2 started at 10% of bases, overlaps counted once
    assert 0.15 < shrink < 0.2
    # a deleted run never crosses into the next pair
    for a, b in zip(q, t):
        assert len(b) <= len(a)
    one = dict(ins, indel_len=[1, 1])
    q, t = _mean_rate(one)
    assert abs(sum(map(len, t)) / sum(map(len, q)) - 1.1) < 0.01
