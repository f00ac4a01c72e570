"""Banded column-sweep cost probe: what each part of a column costs.

PyTorch / CUDA counterpart of `scripts/colband_probe.py` (the Pallas
probe kernel `make_kernel` behind `run_variant`).  The probe keeps the
structure of the production kernel (`csrc/colband.cu`: a sliding window
of RW rows that advances 8 rows per 8-column group, per column the score
feed, the diagonal-H shift, E as a prefix maximum down the column, the
packed (H << 16) + r values merged into a diagonal ring, per group 16
finalised diagonals through a Z-drop chain) and makes three parts
switchable:

* ``with_chain``: the per-group chain over 16 ring entries;
* ``n_prefix``: the log-steps of the E prefix maximum; None or any value
  with 2 ** n_prefix >= RW is the full scan, smaller values look only
  2 ** n_prefix rows up (the CUDA instances take 0 to 3: the scan over
  threads is replaced by one exchange with the neighbouring thread);
* ``with_ring``: the ring merge.

It is timing-faithful and semantically WRONG on purpose: the masks are
placeholder intervals, the chain's carry-in is simplified, the inputs
are synthesised (meta filled with the column count, an all-zero query,
target codes (r + w0) & 3).  Each repetition XORs its result with the
previous one's, as the original chained its repetitions.

Two implementations with the same switches:

* `colband_probe_torch`: the plain version, a transcription of
  `make_kernel` over (RW, N) int32 tensors, any device;
* `colband_probe_cuda`: the probe instances of `csrc/colband.cu`, on
  the production kernel's layout (R = 2, 4 or 8 rows a thread, the R
  that `ops.colband.colband_rows` gives B7 unless asked for another;
  template switches for chain / ring / scan), one block per pair.

    python -m agatha_tpu_torch.probes.colband_probe [G] [NCOLS]

times the seven variants of the original on a CUDA device (G blocks of
128 pairs, NCOLS columns), then the full variant and its four ablations
at B7's headline window (RW 1536, R = 4, one block of 128 pairs), and
prints ns per column of a 128-pair block, the implied GCUPS at band 751
(credited cells per column: 2 * 751 + 1 per pair x 128 pairs) and each
ablation's share of the full variant, with the card's name and power
limit.  Launches on one CUDA stream run in order and are not fused or
hoisted, so the repetitions need no data dependency to be timed back to
back.
"""

from __future__ import annotations

import math
import sys

import torch

from agatha_tpu_torch.constants import (
    INT32_MIN,
    MINUS_INF2,
    N_PENALTY,
    N_VALUE,
)
from agatha_tpu_torch.ops import colband as cb

LN = 128
BW = 751
GOE, GE = 8, 2
MATCH, MISM = 1, 4
Z = 400
NEG_BIG = -(1 << 28)


def _shift_down(x, s, fill):
    return torch.cat([x.new_full((s, x.shape[1]), fill), x[:-s]], dim=0)


def _shift_up(x, s, fill):
    return torch.cat([x[s:], x.new_full((s, x.shape[1]), fill)], dim=0)


def _vchain(seg, d0, carry):
    """The probe's Z-drop chain over a (S, N) ring segment: a first-wins
    prefix argmax, term predicates against the state before each row,
    and the probe's own end-of-segment selection (a stand-in, wrong on
    purpose: see the module docstring)."""
    S = seg.shape[0]
    ms0, mr0, mq0, term0, diags0 = carry
    i32 = torch.int32
    th = seg >> 16
    tr = seg & 0xFFFF
    ri = torch.arange(S, dtype=i32, device=seg.device)[:, None]
    d = (ri + d0).expand_as(seg)

    run_th, run_tr, run_d = th, tr, d
    s = 1
    while s < S:
        pth = _shift_down(run_th, s, NEG_BIG)
        ptr = _shift_down(run_tr, s, 0)
        pd = _shift_down(run_d, s, 0)
        win = pth >= run_th            # earlier wins ties
        run_th = torch.where(win, pth, run_th)
        run_tr = torch.where(win, ptr, run_tr)
        run_d = torch.where(win, pd, run_d)
        s *= 2
    win0 = ms0 >= run_th               # fold the carry-in state
    run_th = torch.where(win0, ms0, run_th)
    run_tr = torch.where(win0, mr0, run_tr)
    run_d = torch.where(win0, mq0 + mr0, run_d)

    # term predicate against the state BEFORE each row
    r0 = ri == 0
    pre_th = torch.where(r0, ms0, _shift_down(run_th, 1, 0))
    pre_tr = torch.where(r0, mr0, _shift_down(run_tr, 1, 0))
    pre_d = torch.where(r0, mq0 + mr0, _shift_down(run_d, 1, 0))
    dq = d - tr
    pre_q = pre_d - pre_tr
    zel = ~(th > pre_th) & (tr >= pre_tr) & (dq >= pre_q)
    gap = ((tr - pre_tr) - (dq - pre_q)).abs()
    tcand = zel & (pre_th - th > Z + gap * GE) | (term0 > 0)
    tpre = tcand.to(i32)
    s = 1
    while s < S:
        tpre = torch.maximum(tpre, _shift_down(tpre, s, 0))
        s *= 2
    live = (tpre == 0) | tcand

    def top(x):
        return torch.where(live, x, NEG_BIG).max(dim=0, keepdim=True).values

    ms = top(run_th)
    mr = top(run_tr)
    mq = top(run_d - run_tr)
    term = tcand.to(i32).max(dim=0, keepdim=True).values
    diags = diags0 + (~tpre).sum(dim=0, keepdim=True).to(i32)
    return ms, mr, mq, term, diags


def full_prefix(RW: int) -> int:
    """Log-steps of the whole-window E prefix maximum."""
    return max(1, math.ceil(math.log2(RW)))


def colband_probe_torch(meta, prev, RW: int, ncols: int, *,
                        with_chain: bool = True, n_prefix: int | None = None,
                        with_ring: bool = True, return_state: bool = False):
    """Plain PyTorch version of the probe (any device).

    meta (2, N) int32 (row 0: the column count of each pair), prev
    (4, N) int32; returns (4, N) int32 [ms, mr, mq, diags] ^ prev, and
    with ``return_state`` also the final H, F and ring stacked as
    (3 RW + 16, N) int32 (the four outputs barely depend on the column
    work, so a comparison of two versions wants the state too).
    """
    if n_prefix is None:
        n_prefix = full_prefix(RW)
    dev = meta.device
    i32 = torch.int32
    n = meta.shape[1]
    qlen = meta[0:1]
    r_iota = torch.arange(RW, dtype=i32, device=dev)[:, None].expand(RW, n)
    ge_r = GE * r_iota
    hp = torch.full((RW, n), MINUS_INF2, dtype=i32, device=dev)
    fi = hp.clone()
    tmw = r_iota & 3
    ring = torch.full((RW + 16, n), INT32_MIN, dtype=i32, device=dev)
    z0 = torch.zeros((1, n), dtype=i32, device=dev)
    carry = (z0, z0, z0, z0, z0)
    qb = torch.zeros((1, n), dtype=i32, device=dev)  # the all-zero query

    for g in range(ncols // 8):
        w0 = 8 * g
        if with_chain:
            carry = _vchain(ring[0:16], 16 * g - 8, carry)
        ring = _shift_up(ring, 16, INT32_MIN)
        hp = _shift_up(hp, 8, MINUS_INF2)
        fi = _shift_up(fi, 8, MINUS_INF2)
        tmw = _shift_up(tmw, 8, 0) | torch.where(
            r_iota >= RW - 8, (r_iota + w0) & 3, 0)
        t_is_n = tmw == N_VALUE
        if with_ring:
            gacc = torch.full((RW + 8, n), INT32_MIN, dtype=i32, device=dev)
        for k in range(8):
            j = 8 * g + k
            lo = j - BW - w0 + (j & 7)
            hi = j + BW - w0 - (j & 3)
            C = (r_iota >= lo) & (r_iota <= hi) & (qlen > j)

            s = torch.where(qb == tmw, MATCH, -MISM)
            s = torch.where((qb == N_VALUE) | t_is_n, -N_PENALTY, s)
            temp = _shift_down(hp, 1, MINUS_INF2) + s

            gv = torch.where(C, temp - GOE + ge_r, NEG_BIG)
            p = _shift_down(gv, 1, NEG_BIG)
            sft = 1
            for _ in range(n_prefix):
                if sft >= RW:
                    break  # already the whole window
                p = torch.maximum(p, _shift_down(p, sft, NEG_BIG))
                sft *= 2
            e_in = p - (ge_r - GE)

            h_new = torch.maximum(torch.maximum(temp, fi), e_in)
            f_new = torch.maximum(gv - ge_r, fi - GE)
            fi = torch.where(C, f_new, fi)
            hp = torch.where(C, h_new, hp)

            if with_ring:
                packed = cb._wrap32((h_new.to(torch.int64) << 16)
                                    + (r_iota + w0))
                packed = torch.where(C, packed, INT32_MIN)
                gacc[k:k + RW] = torch.maximum(gacc[k:k + RW], packed)
        if with_ring:
            ring[8:] = torch.maximum(ring[8:], gacc)
    ms, mr, mq, _term, diags = carry
    out = torch.cat([ms, mr, mq, diags], dim=0) ^ prev
    if return_state:
        return out, torch.cat([hp, fi, ring], dim=0)
    return out


def probe_rows(RW: int, rows: int | None = None) -> int:
    """Rows a thread of the probe instance for a window of RW rows: the
    one B7 takes (`colband_rows`) when None; raises ValueError when no
    instance of `rows` rows a thread takes the window (RW / R row
    threads and the chain warp past its launch bound)."""
    if rows is None:
        rows = cb.colband_rows(RW)
    if rows not in cb.COLBAND_ROWS or cb.block_threads(RW, rows) > \
            cb.max_threads(rows):
        raise ValueError(f"no probe instance of {rows} rows a thread "
                         f"takes a window of {RW} rows")
    return rows


def instance_prefix(RW: int, n_prefix: int | None) -> int:
    """The CUDA instances' n_prefix: -1 for the full scan (None, or a
    window 2 ** n_prefix of the whole RW), else 0 to 3."""
    if n_prefix is None or 2 ** n_prefix >= RW:
        return -1
    if not 0 <= n_prefix <= 3:
        raise ValueError("the CUDA probe takes n_prefix 0 to 3 or the "
                         f"full scan, got {n_prefix}")
    return n_prefix


def colband_probe_cuda(meta, prev, RW: int, ncols: int, *,
                       with_chain: bool = True, n_prefix: int | None = None,
                       with_ring: bool = True, return_state: bool = False,
                       rows: int | None = None):
    """Launch one probe instance on the current stream; (4, N) int32,
    and with ``return_state`` the final state as the plain version
    returns it.  `rows`: the instance's rows a thread (`probe_rows`);
    counted as probe.colband.r<rows>."""
    if RW < 8 or RW % 8 or RW > 4096 or ncols % 8 or ncols < 8:
        raise ValueError(f"RW={RW} must be a multiple of 8 in [8, 4096] "
                         f"and ncols={ncols} a positive multiple of 8")
    rows = probe_rows(RW, rows)
    n = meta.shape[1] if meta.dim() == 2 else -1
    for name, x, height in (("meta", meta, 2), ("prev", prev, 4)):
        if (x.dim() != 2 or x.shape != (height, n) or x.dtype != torch.int32
                or not x.is_contiguous() or x.device != meta.device):
            raise ValueError(f"{name} must be a contiguous ({height}, N) "
                             f"int32 tensor on {meta.device}")
    n_prefix = instance_prefix(RW, n_prefix)
    out = torch.empty_like(prev)
    state = torch.empty((3 * RW + 16, n), dtype=torch.int32,
                        device=meta.device) if return_state else None
    if n == 0:
        return (out, state) if return_state else out
    cb.LIB.launch(
        "agatha_colband_probe", f"probe.colband.r{rows}",
        meta.data_ptr(), prev.data_ptr(), out.data_ptr(),
        state.data_ptr() if return_state else None, n, RW, ncols,
        int(with_chain), n_prefix, int(with_ring), rows, on=meta,
    )
    return (out, state) if return_state else out


def colband_probe(meta, prev, RW, ncols, **switches) -> torch.Tensor:
    """The probe on meta's device: the CUDA instance for CUDA tensors
    (or the call raises), the plain version for CPU tensors."""
    if meta.device.type == "cuda":
        return colband_probe_cuda(meta, prev, RW, ncols, **switches)
    return colband_probe_torch(meta, prev, RW, ncols, **switches)


VARIANTS = (
    # name, RW, switches: the seven variants of the original's main()
    ("full (chain fused)", 1568, {}),
    ("no chain", 1568, {"with_chain": False}),
    ("no prefix (E ablate)", 1568, {"n_prefix": 1}),
    ("no ring", 1568, {"with_ring": False}),
    ("bare (no ring/prefix)", 1568,
     {"n_prefix": 1, "with_ring": False, "with_chain": False}),
    # RW scaling: ns per column against the window height
    ("RW 768", 768, {}),
    ("RW 384", 384, {}),
)


# The full variant and its four ablations at the colband headline's B7
# window and fill: RW 1536 (R = 4 by colband_rows, 12 row warps), one
# block of 128 pairs (one block an SM)
ABLATION_RW, ABLATION_G = 1536, 1
ABLATIONS = tuple((name, ABLATION_RW, switches)
                  for name, _RW, switches in VARIANTS[:5])


def probe_inputs(G: int, ncols: int, device):
    """The probe's synthesised inputs: meta filled with ncols, prev 0."""
    meta = torch.full((2, G * LN), ncols, dtype=torch.int32, device=device)
    prev = torch.zeros((4, G * LN), dtype=torch.int32, device=device)
    return meta, prev


def run_variant(name, RW, G, ncols, *, reps=8, rounds=4, **switches):
    """Time one variant on the card: `reps` and `reps // 2` launches back
    to back between CUDA events, each fed the previous output; the slope
    between the two cancels the fixed ends.  Returns (ns per column of a
    128-pair block, GCUPS-equivalent), the best of `rounds`."""
    meta, prev0 = probe_inputs(G, ncols, "cuda")

    def timeit(n):
        best = float("inf")
        for _ in range(rounds):
            prev = prev0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                prev = colband_probe_cuda(meta, prev, RW, ncols, **switches)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    timeit(1)  # warm-up (and the build)
    t_full = timeit(reps)
    t_half = timeit(reps // 2)
    dcols = G * ncols * (reps - reps // 2)
    ns_col = (t_full - t_half) * 1e6 / dcols
    gcups = LN * (2 * BW + 1) / ns_col
    R = probe_rows(RW, switches.get("rows"))
    print(f"{name:22s} RW={RW:5d} R={R} G={G}: {t_full:8.3f}/"
          f"{t_half:8.3f} ms {ns_col:9.2f} ns/col -> {gcups:7.2f} "
          "GCUPS-equiv", flush=True)
    return ns_col, gcups


def main(argv: list[str] | None = None) -> int:
    from agatha_tpu_torch.bench import device_line

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    G = int(argv[0]) if len(argv) > 0 else 8
    ncols = int(argv[1]) if len(argv) > 1 else 2048
    print(f"# device={device_line()}")
    print(f"banded column-sweep probe: G={G} blocks of {LN} pairs x "
          f"{ncols} columns, bw={BW}", flush=True)
    for variants, g in ((VARIANTS, G), (ABLATIONS, ABLATION_G)):
        ns = {name: run_variant(name, RW, g, ncols, **switches)[0]
              for name, RW, switches in variants}
        full = ns[variants[0][0]]
        print("  share of the full variant: " + ", ".join(
            f"{name} {v / full:.4f}" for name, v in ns.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
