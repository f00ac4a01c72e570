"""The yardstick's constants and counts: peaks, operations per cell, and
the in-band cells of an alignment.

The operation counts and peaks are copied from `chip_smoke.py` (the
bring-up's bound), each term as derived there from the recurrence.  The
counts are of the alignment's work, not of any kernel's, so a share
reads the same whatever kernel or route serves a batch.

Caution: DPX instructions (`__vimax3_s32` and kin) issue a 3-way maximum
as one instruction, where the count below has two operations; a share
near 100% would need the count revisited.  The antidiagonal kernel
stands near 8% of this bound (the bring-up's records).
"""

from __future__ import annotations

import numpy as np

# H100 SXM: 3.35 TB/s of HBM3; 132 SMs x 64 int32 lanes x 1.98 GHz
# boost = 16.7 T int32 operations/s.  Assumed from the data sheet, not
# measured: the run prints the card's SM clock and power limit beside
# every share.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations the DP recurrence needs per cell, at least:
# substitution score (a per-column 16-entry profile indexed by the
# target code: 2), temp (1), H (2 max), F (temp - goe, f - ge, max: 3),
# E (e - ge, max, temp - goe shared with F: 2), (H << 16) + r (one
# IMAD: 1), the diagonal max (1).
OPS_PER_CELL = 12
# the traceback nibble per cell, beyond the recurrence: E > temp and
# F > max(temp, E) (2), the source select (1), the two open tests (2;
# e - ge and f - ge are the recurrence's), packing the nibble (2), the
# shift-or into the plane word (1)
OPS_PER_NIBBLE = 8
# per move of the walk: state and source tests (3), move select (2),
# cursor updates (2), shift-or into the word (1), lane and nibble
# extraction (2)
OPS_PER_MOVE = 10
# bytes a pair writes at least: score, query end, target end, diagonals
OUT_BYTES_PER_PAIR = 16


def banded_cells(qlens, rlens, diags, band_width) -> int:
    """Exact in-band cell count over the first `diags` antidiagonals
    (the port's `utils.workload.banded_cells`, copied)."""
    total = 0
    for ql, rl, nd in zip(qlens, rlens, diags):
        d = np.arange(int(nd), dtype=np.int64)
        ub = np.minimum(np.minimum(rl - 1, d), (d + band_width) // 2)
        lb = np.maximum(
            np.maximum(0, d - ql + 1), -((band_width - d) // 2)
        )
        total += int(np.maximum(0, ub - lb + 1).sum())
    return total


def input_bytes(qlens, rlens) -> int:
    """4-bit codes of both sequences read once, and two int32 lengths."""
    q = np.asarray(qlens, np.int64)
    r = np.asarray(rlens, np.int64)
    return int(((q + 1) // 2 + (r + 1) // 2 + 8).sum())


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the int32
    peak or bytes over HBM, whichever is longer."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def score_least(cells: int, qlens, rlens) -> float:
    """A score-only batch: 12 operations an in-band cell; its codes read
    and its four results written once."""
    n = len(qlens)
    return least_seconds(OPS_PER_CELL * cells,
                         input_bytes(qlens, rlens) + OUT_BYTES_PER_PAIR * n)


def traceback_least(cells: int, moves: int, qlens, rlens) -> float:
    """A batch with CIGARs: 12 + 8 operations an in-band cell and 10 a
    move of the path; the flag bitmap is an intermediate and not
    counted, the path written once at 2 bits a move."""
    n = len(qlens)
    return least_seconds(
        (OPS_PER_CELL + OPS_PER_NIBBLE) * cells + OPS_PER_MOVE * moves,
        input_bytes(qlens, rlens) + OUT_BYTES_PER_PAIR * n + moves // 4)
