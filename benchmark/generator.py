"""The one traffic generator: homologous pairs drawn from a traffic file.

The model of the port's `utils.workload.make_workload` (the long-read
seed-extension regime), vectorised so that a run can pay for it: a
query of uniform random bases, and a target that copies it with
substitutions (a random base, so 3 in 4 change it), insertions of 1-3
random bases before a query base, and deletions of 1-3 query bases, at
the traffic file's divergence split into its shares.  Each event is
drawn once a query base, so a deletion run may overlap another; the
result is not byte-identical to `make_workload`'s, whose loop skips the
bases it deletes.

The bases are drawn on the run's device, from a `torch.Generator` there
seeded by the run's seed, in chunks of up to 2M bases; only the bytes
come back to the host as strings, since the window's first layer encodes
strings.  Every batch of a seed holds the same set of query lengths
(evenly spaced over mean +- spread), in an order drawn from the seed, so
two seeds give the same amount of work in another order, and only the
bases differ.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = b"ACGT"


def lengths(traffic: dict) -> np.ndarray:
    """The query lengths of one batch, evenly spaced over the range."""
    n = int(traffic["pairs_per_batch"])
    mean, spread = float(traffic["mean_len"]), float(traffic["spread"])
    lo = max(1, int(mean * (1 - spread)))
    hi = max(lo + 1, int(mean * (1 + spread)))
    return lo + ((np.arange(n) + 0.5) * (hi - lo) / n).astype(np.int64)


def _u16(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(0, 65536, (n,), generator=gen, device=gen.device,
                         dtype=torch.int32)


# bases drawn in one go: a chunk's arrays take ~40 bytes a base on the
# device, so set-up's memory stays near the program's own
CHUNK_BASES = 1 << 21


def make_batch(traffic: dict, gen: torch.Generator):
    """One batch: (queries, targets) as lists of ASCII strings."""
    perm = torch.randperm(int(traffic["pairs_per_batch"]), generator=gen,
                          device=gen.device)
    qlens = lengths(traffic)[perm.cpu().numpy()]
    queries, targets = [], []
    lo = 0
    while lo < len(qlens):
        hi = lo + 1
        total = int(qlens[lo])
        while hi < len(qlens) and total + qlens[hi] <= CHUNK_BASES:
            total += int(qlens[hi])
            hi += 1
        q, t = _draw(traffic, qlens[lo:hi], gen)
        queries += q
        targets += t
        lo = hi
    return queries, targets


def _draw(traffic: dict, qlens: np.ndarray, gen: torch.Generator):
    """The pairs of the given query lengths, drawn in one go."""
    dev = gen.device
    n_pairs = len(qlens)
    total = int(qlens.sum())
    div = float(traffic["divergence"])
    # event thresholds on 16-bit uniforms
    t_del = round(65536 * div * float(traffic["deletion_share"]))
    t_ins = t_del + round(65536 * div * float(traffic["insertion_share"]))
    t_sub = round(65536 * div * float(traffic["substitution_share"]))
    lmin, lmax = (int(x) for x in traffic["indel_len"])
    bases = torch.tensor(list(BASES), dtype=torch.uint8, device=dev)

    codes = torch.randint(0, 256, (total,), generator=gen, device=dev,
                          dtype=torch.uint8)
    q = bases[(codes & 3).long()]
    pair = torch.repeat_interleave(
        torch.arange(n_pairs, device=dev, dtype=torch.int32),
        torch.as_tensor(qlens, device=dev))
    u = _u16(gen, total)
    run = lmin + ((_u16(gen, total) * (lmax - lmin + 1)) >> 16)
    starts = torch.nonzero(u < t_del).squeeze(1)
    deleted = torch.zeros(total, dtype=torch.bool, device=dev)
    for k in range(lmax):
        pos = starts + k
        ok = (pos < total) & (run[starts] > k)
        pos, st = pos[ok], starts[ok]
        pos = pos[pair[pos] == pair[st]]
        deleted[pos] = True
    ins_at = torch.nonzero((u >= t_del) & (u < t_ins) & ~deleted).squeeze(1)
    sub = _u16(gen, total) < t_sub
    base = torch.where(sub, bases[((codes >> 2) & 3).long()], q)

    # target = for each query base, its inserted run then the base
    count = (~deleted).to(torch.int64)
    count[ins_at] += run[ins_at].to(torch.int64)
    ends = torch.cumsum(count, 0)
    t = torch.empty(int(ends[-1]), dtype=torch.uint8, device=dev)
    kept = torch.nonzero(~deleted).squeeze(1)
    t[ends[kept] - 1] = base[kept]
    runs = run[ins_at].to(torch.int64)
    ins_pos = torch.repeat_interleave(ends[ins_at] - count[ins_at], runs)
    first = torch.repeat_interleave(torch.cumsum(runs, 0) - runs, runs)
    ins_pos += torch.arange(len(ins_pos), device=dev) - first
    t[ins_pos] = bases[(torch.randint(0, 4, (len(ins_pos),), generator=gen,
                                      device=dev)).long()]
    # a pair's target ends where its last query base's count does
    qo = np.concatenate([[0], np.cumsum(qlens)])
    to = np.concatenate([[0], ends[torch.as_tensor(
        qo[1:] - 1, device=dev)].cpu().numpy()])

    qb = q.cpu().numpy().tobytes()
    tb = t.cpu().numpy().tobytes()
    queries = [qb[qo[i]:qo[i + 1]].decode("ascii") for i in range(n_pairs)]
    targets = [tb[to[i]:to[i + 1]].decode("ascii") or "A"
               for i in range(n_pairs)]
    return queries, targets


def make_pool(traffic: dict, n_batches: int, seed: int,
              device: str = "cpu"):
    """The run's distinct batches, all drawn from one seed on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [make_batch(traffic, gen) for _ in range(n_batches)]
