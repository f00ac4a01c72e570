"""The batched reference against the frozen oracle, and CIGAR rescoring."""

import numpy as np
import pytest

from benchmark import oracle, reference
from benchmark.reference import Scoring

AGATHA_SH = Scoring(1, 4, 6, 2, 3, 400, 751)
MANUAL = Scoring(2, 4, 4, 2, 3, 400, 751)
BASES = np.array(list("ACGT"))


def mutate(rng, s, sub=0.1, indel=0.05):
    out, i = [], 0
    while i < len(s):
        u = rng.random()
        if u < indel / 2:
            i += int(rng.integers(1, 4))
            continue
        if u < indel:
            out.extend(BASES[rng.integers(0, 4, int(rng.integers(1, 4)))])
        out.append(BASES[rng.integers(0, 4)] if rng.random() < sub else s[i])
        i += 1
    return "".join(out) or "A"


def pairs(seed, n, lo, hi, *, n_runs=False, unrelated=False):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for p in range(n):
        q = "".join(BASES[rng.integers(0, 4, int(rng.integers(lo, hi)))])
        if n_runs and p % 3 == 0:
            k = len(q) // 2
            q = q[:k] + "N" * 12 + q[k:]
        t = ("".join(BASES[rng.integers(0, 4, int(rng.integers(lo, hi)))])
             if unrelated and p % 2 else mutate(rng, q))
        qs.append(q)
        ts.append(t)
    return qs, ts


def oracle_rows(qs, ts, sc):
    return np.array([oracle.align_one_sweep(
        reference.encode(q), reference.encode(t), len(q), len(t), sc)
        for q, t in zip(qs, ts)])


def ref_rows(qs, ts, sc, **kw):
    r = reference.align(qs, ts, sc, **kw)
    return np.stack([r["score"], r["query_end"], r["target_end"],
                     r["diags"]], 1)


CASES = [
    # (scoring, seed, pairs, lengths, options)
    (AGATHA_SH, 1, 10, (1, 400), dict(n_runs=True)),
    (MANUAL, 2, 10, (1, 400), dict(unrelated=True)),
    # Z-drop exits on unrelated halves; a narrow band that the window
    # follows down long pairs
    (Scoring(1, 4, 6, 2, 3, 30, 31), 3, 8, (200, 900),
     dict(unrelated=True)),
    (Scoring(1, 4, 6, 2, 3, 400, 15), 4, 6, (600, 1200), {}),
    # Z-drop off, another slice width
    (Scoring(3, 1, 1, 1, 2, -1, 63), 5, 8, (1, 300), dict(n_runs=True)),
    # scores past 2^15 within a few kb: the int16 strips wrap them
    (Scoring(20, 4, 4, 2, 3, 400, 101), 6, 3, (1900, 2400), {}),
]


@pytest.mark.parametrize("sc,seed,n,lens,opts", CASES)
def test_reference_equals_the_frozen_oracle(sc, seed, n, lens, opts):
    qs, ts = pairs(seed, n, *lens, **opts)
    np.testing.assert_array_equal(ref_rows(qs, ts, sc),
                                  oracle_rows(qs, ts, sc))


def test_band_edges_and_all_n():
    sc = Scoring(1, 4, 6, 2, 3, 400, 31)
    rng = np.random.default_rng(9)
    q = "".join(BASES[rng.integers(0, 4, 300)])
    qs = [q, q, "N" * 40, "A", q[:5]]
    # a target shifted by the band width and by one more; all N; 1 base
    ts = ["C" * 31 + q, "C" * 33 + q, "N" * 37, "A", "G" * 64 + q[:5]]
    got = ref_rows(qs, ts, sc)
    np.testing.assert_array_equal(got, oracle_rows(qs, ts, sc))
    r = reference.align(qs, ts, sc)
    assert not r["updated"][2]          # all N: never a positive maximum
    assert r["updated"][0]


def test_the_control_differs_where_its_precision_cannot_hold():
    qs, ts = pairs(1, 6, 200, 400)
    exact = ref_rows(qs, ts, AGATHA_SH)
    assert (ref_rows(qs, ts, AGATHA_SH, bits=8) != exact).any(axis=1).all()
    # int16 is exact where every value fits it
    np.testing.assert_array_equal(ref_rows(qs, ts, AGATHA_SH, bits=16),
                                  exact)
    wide = Scoring(20, 4, 4, 2, 3, 400, 101)
    qs, ts = pairs(6, 3, 1900, 2400)
    assert (ref_rows(qs, ts, wide, bits=16)
            != ref_rows(qs, ts, wide)).any()


def test_rescore_on_hand_counted_paths():
    sc = AGATHA_SH
    assert reference.rescore("4M", "ACGT", "ACGT", sc) == (4, 4, 4)
    assert reference.rescore("2M", "ACGT", "AGGT", sc) == (1 - 4, 2, 2)
    # a 2-base insertion (query only) costs 6 + 2 * 2
    assert reference.rescore("1M2I1M", "AGGC", "AC", sc) == (2 - 10, 4, 2)
    assert reference.rescore("1M1D1M", "AC", "AGC", sc) == (2 - 8, 2, 3)
    assert reference.rescore("1M", "N", "A", sc) == (-1, 1, 1)
    for bad in ("5M", "1X", "M", "0M", "1M1", "3D"):
        assert reference.rescore(bad, "ACGT", "AC", sc) is None
