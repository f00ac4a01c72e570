"""The comparison that decides `correct`.

Answers are checked one by one: a sample, drawn from the seed, of the
pairs that batches completed in the window returned, with the pool's
longest pair always in it, against the plain reference
(`benchmark.reference`) run on the same strings once the window has
closed.  Every field is compared exactly (score, query end, target end,
antidiagonals swept), so each limit is 0.  With CIGARs, each sampled
CIGAR is judged by what it says: its path from the origin has to end at
the reference's ends and score the reference's score (an end outside the
band, where the reference can report a stale carry no path reproduces,
only has to score no more); a pair whose maximum the reference never
updated has to get the empty CIGAR.

The candidates are fixed before the window: for each batch ordinal a
seeded set of pair indices (plus the longest), whose answers the window
keeps; the sample is then drawn among those of the completed batches.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference


def scoring(config: dict) -> reference.Scoring:
    return reference.Scoring(**config["align"])


class Keeper:
    """What the window keeps of each completed batch: the four fields of
    every pair (for the cell count) and the CIGARs of the candidates."""

    def __init__(self, pool, seed: int, per_batch: int):
        self.pool = pool
        self.seed = seed
        self.n = len(pool[0][0])
        self.per_batch = min(per_batch, self.n)
        lens = [np.array([len(q) + len(t) for q, t in zip(*b)])
                for b in pool]
        self.longest = [int(np.argmax(x)) for x in lens]
        self.batches: list[tuple[int, np.ndarray, dict]] = []

    def candidates(self, ordinal: int, pool_index: int) -> np.ndarray:
        """The seeded pair indices of a batch ordinal, and the longest."""
        rng = np.random.default_rng([self.seed, 0xC4EC, ordinal])
        c = rng.choice(self.n, size=self.per_batch, replace=False)
        return np.union1d(c, [self.longest[pool_index]])

    def keep(self, ordinal: int, pool_index: int, result) -> None:
        fields = np.stack([result.scores, result.query_ends,
                           result.target_ends, result.diags], 1)
        cig = {}
        if result.cigars is not None:
            for i in self.candidates(ordinal, pool_index):
                cig[int(i)] = result.cigars[i]
        self.batches.append((pool_index, fields.astype(np.int64), cig))


def draw_sample(keeper: Keeper, seed: int, size: int):
    """(batch ordinal, pair index) pairs to check: `size` drawn from the
    candidates of the completed batches, and the longest pair of the
    last completed batch."""
    cands = [(k, int(i)) for k, (pi, _f, _c) in enumerate(keeper.batches)
             for i in keeper.candidates(k, pi)]
    rng = np.random.default_rng([seed, 0x5A3B])
    pick = rng.choice(len(cands), size=min(size, len(cands)), replace=False)
    out = {cands[j] for j in pick}
    last = len(keeper.batches) - 1
    out.add((last, keeper.longest[keeper.batches[last][0]]))
    return sorted(out)


def compare(keeper: Keeper, sample, config: dict, device, *,
            traceback: bool, program: np.ndarray | None = None) -> dict:
    """Run the reference over the sample and count what differs.

    Returns {name: (value, limit)} plus "checked".  ``program`` (the
    control) stands in for the program's kept answers, (len(sample), 4).
    """
    sc = scoring(config)
    qs = [keeper.pool[keeper.batches[k][0]][0][i] for k, i in sample]
    ts = [keeper.pool[keeper.batches[k][0]][1][i] for k, i in sample]
    ref = reference.align(qs, ts, sc, device=device)
    want = np.stack([ref["score"], ref["query_end"], ref["target_end"],
                     ref["diags"]], 1)
    if program is None:
        got = np.stack([keeper.batches[k][1][i] for k, i in sample])
    else:
        got = program
    wrong = int((got != want).any(axis=1).sum())
    out = {"pairs_wrong": (wrong, 0), "checked": len(sample)}
    if traceback:
        bad = 0
        for j, (k, i) in enumerate(sample):
            cig = keeper.batches[k][2].get(i)
            if not ref["updated"][j]:
                bad += cig != ""
                continue
            got_path = reference.rescore(cig or "", qs[j], ts[j], sc)
            qe, te = int(want[j, 1]), int(want[j, 2])
            if got_path is None or got_path[1:] != (qe + 1, te + 1):
                bad += 1
            elif abs(qe - te) <= sc.band_width:
                bad += got_path[0] != int(want[j, 0])
            else:
                bad += got_path[0] > int(want[j, 0])
        out["cigars_wrong"] = (bad, 0)
    return out


def control_reading(keeper: Keeper, sample, config: dict, device) -> dict:
    """The control: the reference at the configuration's control
    precision put in the program's place, judged like the program."""
    sc = scoring(config)
    qs = [keeper.pool[keeper.batches[k][0]][0][i] for k, i in sample]
    ts = [keeper.pool[keeper.batches[k][0]][1][i] for k, i in sample]
    low = reference.align(qs, ts, sc, device=device,
                          bits=int(config["control_bits"]))
    got = np.stack([low["score"], low["query_end"], low["target_end"],
                    low["diags"]], 1)
    return compare(keeper, sample, config, device, traceback=False,
                   program=got)
