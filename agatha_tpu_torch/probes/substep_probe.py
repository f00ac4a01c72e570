"""The B1 substep as the cost probes P3 and P4 run it: the plain PyTorch
version, the cell counter and the launcher of csrc/substep_probe.cu.

`scripts/wave_probe.py` (P3) and `scripts/skew_probe.py` (P4) time one
base antidiagonal of the antidiagonal kernel in isolation: the DP core,
the packed `(H << 16) + r` row maximum and the Z-drop bookkeeping, over
(B, W) int32 lane state, with the production mask formulas but no
boundary or window semantics (the scores are garbage on purpose; the
state starts as iotas).  They differ in how a substep is framed:

* the current frame (`make_waves`, `make_current`): lane = row, the
  per-lane masks hoisted once per packed diagonal, three rolls per
  substep (qwin, the diagonal H, E);
* the skewed frame (`make_skewed`): lane = row - r_lo(d), the frame
  advances every second substep, which then rolls tb, F and H and
  recomputes the masks; the diagonal H needs no roll;
* interval masks (`*_ival`): C as two lane-range tests against per-pair
  bounds computed once per packed diagonal;
* waves (`make_waves`): n_waves independent copies (lengths offset by
  +w) interleaved substep by substep, folded by max (ms, mr, mq) and sum
  (diags) at the end.

`make_current` is `make_waves` with one wave, so one plain function
covers all five factories.  The CUDA instances (`launch`) compute the
same lanes x substeps grid as the tile kernel computes the DP's: 8x8
tiles of (lane, substep) cells, one thread per tile row, one tile a
step (`csrc/substep_probe.cu` says why that order is exact).  Pairs are
rows: the original's programs of B pairs share nothing but their shape
(the row max is per pair, every program initialises the same scratch),
so G programs of B rows are one (G * B, W) problem here.  `(h_new << 16) + r` wraps as int32 does in
XLA (H drifts far below MINUS_INF2 over thousands of substeps).
"""

from __future__ import annotations

import ctypes

import torch

from agatha_tpu_torch.constants import (
    INT32_MIN,
    MINUS_INF2,
    N_PENALTY,
    N_VALUE,
)
from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.ops.colband import _wrap32

LANE = 128
FEED_W = 3 * LANE        # width of the qfw / tfw feed scratch
SW = 3
BW = 751
GOE, GE = 8, 2
MATCH, MISM = 1, 4
Z = 400
CBW = -(-BW // 8)
FBW = (BW + 7) >> 3

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _nvcc.Library("substep_probe.cu", {
    "agatha_substep_probe": ([_vp] * 3 + [_ci] * 7 + [_vp], _ci),
    "agatha_substep_probe_occupancy": ([_ci] * 4 + [ctypes.POINTER(_ci)],
                                       _ci),
})


def _max(a, b):
    """Elementwise max of two tensors, or of a tensor and an int."""
    if not torch.is_tensor(a):
        a, b = b, a
    return torch.maximum(a, b) if torch.is_tensor(b) else a.clamp(min=b)


def _min(a, b):
    if not torch.is_tensor(a):
        a, b = b, a
    return torch.minimum(a, b) if torch.is_tensor(b) else a.clamp(max=b)


def _ctrunc16(t: int) -> int:
    return t >> 4 if t >= 0 else -((-t) >> 4)


def _roll1(x):
    return torch.roll(x, 1, dims=-1)


def _slice_bounds(i: int, pql, prl):
    ss = (i - pql + 1).clamp(min=0).clamp(min=_ctrunc16((i << 3) + (8 - BW)))
    se = (prl - 1).clamp(max=i + (SW - 1)).clamp(
        max=_ctrunc16((i << 3) + (8 * (SW - 1) + 7 + BW)))
    return ss, se


def _cell_terms(r, D: int, i1: int, pql, bounds):
    """The per-lane slice / chunk terms of the cell-by-cell masks."""
    ss1, se1, ss2, se2 = bounds
    pr = r >> 3
    cs = ((pr << 3) - BW).clamp(min=0) >> 3
    ce = _min(pql - 1, ((pr << 3) + (7 + BW)) >> 3)
    insl_a = (pr >= ss1) & (pr <= se1)
    insl_b = (pr >= ss2) & (pr <= se2)
    pq_a = D - pr
    pq_b = pq_a - 1
    x_a = insl_a & (pq_a >= cs) & (pq_a <= ce)
    x_b = insl_b & (pq_b >= cs) & (pq_b <= ce)
    y_a = x_a & (pq_a > cs) & (pq_a < ce)
    y_b = x_b & (pq_b > cs) & (pq_b < ce)
    cse_a = pq_a == _max(cs, i1 - pr)
    return x_a, x_b, y_a, y_b, cse_a


def _cell_mask(terms, r, d, k, qlen):
    """C and the chunk-start test of the cell-by-cell masks."""
    x_a, x_b, y_a, y_b, cse_a = terms
    ro = r & 7
    qq = d - r
    valid = (qq >= 0) & (qq < qlen)
    in_band = (d - (r << 1)).abs() <= BW
    z_a = y_a | (x_a & in_band)
    z_b = y_b | (x_b & in_band)
    C = valid & (((ro > k) & z_b) | ((ro <= k) & z_a))
    cst = (ro == k) & (qq >= 0) & cse_a
    return C, cst


def _ival_bounds(D: int, i1: int, pql, bounds):
    """The per-pair interval bounds of one packed diagonal."""
    ss1, se1, ss2, se2 = bounds

    def chunk_iv(Dv, ss, se):
        lo = _max((Dv - pql + 1).clamp(min=(Dv - FBW + 1) >> 1), ss)
        hi = se.clamp(max=min(Dv, (Dv + CBW) >> 1))
        return lo << 3, (hi << 3) + 7, (lo + 1) << 3, ((hi - 1) << 3) + 7

    a = chunk_iv(D, ss1, se1)
    b = chunk_iv(D - 1, ss2, se2)
    cse_row_a = _max(a[0] >> 3, i1 - (D - (a[0] >> 3)))
    return a + b + (cse_row_a << 3,)


def _ival_mask(iv, r, d, k, qlen):
    """C and the chunk-start test from the interval bounds."""
    alo, ahi, aylo, ayhi, blo, bhi, bylo, byhi, cr = iv
    bandlo = (d - BW + 1) >> 1
    bandhi = (d + BW) >> 1
    vlo = d - qlen + 1
    lo_a = _max(_min(aylo, _max(alo, bandlo)), vlo)
    hi_a = _min(_max(ayhi, _min(ahi, bandhi)), d)
    lo_b = _max(_min(bylo, _max(blo, bandlo)), vlo)
    hi_b = _min(_max(byhi, _min(bhi, bandhi)), d)
    ro = r & 7
    in_a = (r >= lo_a) & (r <= hi_a)
    in_b = (r >= lo_b) & (r <= hi_b)
    C = ((ro > k) & in_b) | ((ro <= k) & in_a)
    cst = (ro == k) & (r >= cr) & (r <= cr + 7)
    return C, cst


def _core(qwin, tb, htl, e_in, f_in, C, r, d, bk):
    """The DP core and the Z-drop bookkeeping (kernel.py _inner)."""
    ms, mr, mq, term, diags = bk
    s = torch.where(qwin == tb, MATCH, -MISM).to(torch.int32)
    s = torch.where(tb == N_VALUE, -N_PENALTY, s)
    s = torch.where(qwin == N_VALUE, -N_PENALTY, s)
    temp = htl + s
    h_new = torch.maximum(torch.maximum(temp, f_in), e_in)
    tg = temp - GOE
    f_out = torch.where(C, torch.maximum(tg, f_in - GE), f_in)
    e_out = torch.where(C, torch.maximum(tg, e_in - GE), e_in)
    h_out = torch.where(C, h_new, htl)
    packed = _wrap32((h_new.to(torch.int64) << 16) + r)
    packed = torch.where(C, packed, INT32_MIN)
    dmax = packed.max(dim=-1, keepdim=True).values
    live = term == 0
    th = dmax >> 16
    tr = dmax & 0xFFFF
    dq = d - tr
    upd = live & (th > ms)
    zel = live & ~(th > ms) & (tr >= mr) & (dq >= mq)
    gap = ((tr - mr) - (dq - mq)).abs()
    term = torch.where(zel & (ms - th > Z + gap * GE), 1, term)
    ms = torch.where(upd, th, ms)
    mr = torch.where(upd, tr, mr)
    mq = torch.where(upd, dq, mq)
    diags = diags + live.to(torch.int32)
    return h_out, e_out, f_out, (ms, mr, mq, term, diags)


def _check(n_waves: int, skewed: bool, ival: bool) -> None:
    if n_waves not in (1, 2, 4) or (n_waves > 1 and (skewed or ival)):
        raise ValueError(f"n_waves={n_waves} must be 1, 2 or 4, and 1 in "
                         "the skewed frame or with interval masks")


def plain(meta, W: int, n_diags: int, *, n_waves: int = 1,
          skewed: bool = False, ival: bool = False):
    """Plain PyTorch version of one probe instance (any device).

    meta (N, 2) int32 [qlen, rlen] per pair.  Returns ((N, 4) int32
    [ms, mr, mq, diags], the final scratch in the original's order
    concatenated along lanes, the number of C-true cells): per wave hfa,
    hfb, fst, est, qwin, tb (W lanes each), then each wave's qfw and, in
    the skewed frame, tfw (384 lanes each).
    """
    _check(n_waves, skewed, ival)
    dev = meta.device
    i32 = torch.int32
    n = meta.shape[0]
    lane = torch.arange(W, dtype=i32, device=dev)[None, :]
    lane0 = lane == 0
    fiota = torch.arange(FEED_W, dtype=i32, device=dev)[None, :].expand(
        n, FEED_W)
    zeros = torch.zeros((n, 1), dtype=i32, device=dev)
    minf = torch.full((n, W), MINUS_INF2, dtype=i32, device=dev)

    waves = []
    for w in range(n_waves):
        qlen = meta[:, 0:1] + w
        rlen = meta[:, 1:2] + w
        waves.append({
            "qlen": qlen, "rlen": rlen,
            "pql": (qlen + 7) >> 3, "prl": (rlen + 7) >> 3,
            "hfa": (lane + w).expand(n, W).clone(),
            "hfb": (lane + 1 + w).expand(n, W).clone(),
            "fst": minf.clone(), "est": minf.clone(),
            "qwin": ((lane + w) & 3).expand(n, W).clone(),
            "tb": (((lane + w) >> 2) & 3).expand(n, W).clone(),
            "qfw": (fiota + w) & 3,
            "bk": (zeros,) * 5,
        })
    tfw = fiota & 3
    cells = 0
    rlo = 0
    i1 = kph = 0
    for d8 in range(0, 8 * n_diags, 8):
        D = d8 >> 3
        phase = d8 & 127
        i2 = i1 - SW if kph == 0 else i1
        for wv in waves:
            wv["feed"] = torch.roll(wv["qfw"][:, :LANE], LANE - phase, 1)
            wv["bounds"] = (*_slice_bounds(i1, wv["pql"], wv["prl"]),
                            *_slice_bounds(i2, wv["pql"], wv["prl"]))
            if ival:
                wv["iv"] = _ival_bounds(D, i1, wv["pql"], wv["bounds"])
            elif not skewed:
                wv["terms"] = _cell_terms(lane, D, i1, wv["pql"],
                                          wv["bounds"])
        tfeed = torch.roll(tfw[:, :LANE], LANE - phase, 1)
        r = rlo + lane
        for k in range(8):
            d = d8 + k
            advance = skewed and k % 2 == 1
            if advance:
                rlo += 1
                r = r + 1
            for wv in waves:
                if advance:
                    wv["tb"] = torch.where(lane0, tfeed[:, k:k + 1],
                                           _roll1(wv["tb"]))
                    wv["fst"] = torch.where(lane0, MINUS_INF2,
                                            _roll1(wv["fst"]))
                    wv["hfb"] = torch.where(lane0, MINUS_INF2,
                                            _roll1(wv["hfb"]))
                if ival:
                    C, cst = _ival_mask(wv["iv"], r, d, k, wv["qlen"])
                    fake = prev_fake = True
                else:
                    terms = (_cell_terms(r, D, i1, wv["pql"], wv["bounds"])
                             if skewed else wv["terms"])
                    C, cst = _cell_mask(terms, r, d, k, wv["qlen"])
                    fake, prev_fake = r >= wv["rlen"], r > wv["rlen"]
                cells = cells + C.sum()
                h2 = "hfb" if k % 2 == 0 else "hfa"
                if skewed:
                    if not advance:
                        wv["qwin"] = torch.where(lane0, wv["feed"][:, k:k + 1],
                                                 _roll1(wv["qwin"]))
                        e_in = torch.where(lane0, MINUS_INF2,
                                           _roll1(wv["est"]))
                    else:
                        e_in = wv["est"]
                    htl = wv[h2]
                else:
                    wv["qwin"] = torch.where(lane0, wv["feed"][:, k:k + 1],
                                             _roll1(wv["qwin"]))
                    htl = torch.where(lane0, MINUS_INF2, _roll1(wv[h2]))
                    e_in = torch.where(lane0, MINUS_INF2, wv["est"])
                htl = torch.where(cst & prev_fake, MINUS_INF2, htl)
                f_in = torch.where(cst & fake, MINUS_INF2, wv["fst"])
                h_out, e_out, f_out, wv["bk"] = _core(
                    wv["qwin"], wv["tb"], htl, e_in, f_in, C, r, d, wv["bk"])
                wv[h2] = h_out
                wv["est"] = e_out if skewed else _roll1(e_out)
                wv["fst"] = f_out
        kph += 1
        if kph >= SW:
            i1, kph = i1 + SW, 0

    bks = [wv["bk"] for wv in waves]
    ms, mr, mq, _term, dg = bks[0]
    for bk in bks[1:]:
        ms = torch.maximum(ms, bk[0])
        mr = torch.maximum(mr, bk[1])
        mq = torch.maximum(mq, bk[2])
        dg = dg + bk[4]
    out = torch.cat([ms, mr, mq, dg], dim=1)
    state = [wv[key] for wv in waves
             for key in ("hfa", "hfb", "fst", "est", "qwin", "tb")]
    state += [wv["qfw"] for wv in waves] + ([tfw] if skewed else [])
    return out, torch.cat(state, dim=1), int(cells)


def count_cells(meta, W: int, n_diags: int, *, n_waves: int = 1,
                skewed: bool = False, ival: bool = False) -> int:
    """The C-true cells of `plain` on these inputs, from the same mask
    functions with the 8 substeps of a packed diagonal at once (no DP:
    the masks do not depend on the state)."""
    _check(n_waves, skewed, ival)
    dev = meta.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    k = torch.arange(8, dtype=torch.int32, device=dev)[:, None, None]
    cells = 0
    for w in range(n_waves):
        qlen = meta[:, 0:1] + w
        rlen = meta[:, 1:2] + w
        pql, prl = (qlen + 7) >> 3, (rlen + 7) >> 3
        i1 = 0
        for D in range(n_diags):
            kph = D - i1
            i2 = i1 - SW if kph == 0 else i1
            bounds = (*_slice_bounds(i1, pql, prl),
                      *_slice_bounds(i2, pql, prl))
            # the skewed frame has advanced (k + 1) // 2 rows at substep k
            r = lane + (4 * D + ((k + 1) >> 1) if skewed else 0)
            d = 8 * D + k
            if ival:
                C, _ = _ival_mask(_ival_bounds(D, i1, pql, bounds), r, d, k,
                                  qlen)
            else:
                C, _ = _cell_mask(_cell_terms(r, D, i1, pql, bounds), r, d,
                                  k, qlen)
            cells = cells + C.sum()
            if kph == SW - 1:
                i1 += SW
    return int(cells)


def state_width(W: int, n_waves: int, skewed: bool) -> int:
    """Lanes of the final state `plain` and `launch` return."""
    return 6 * n_waves * W + (n_waves + int(skewed)) * FEED_W


def check_args(meta, W: int, n_diags: int, n_waves: int, skewed: bool,
               ival: bool) -> None:
    """Raise on anything the CUDA instances do not take."""
    _check(n_waves, skewed, ival)
    if W % 32 or W < 32 or W * n_waves > 1024:
        raise ValueError(f"W={W} must be a multiple of 32, and W x n_waves "
                         "at most 1024 (one thread per tile row of 8 "
                         "lanes, at most 128)")
    if n_diags < 0:
        raise ValueError(f"n_diags={n_diags} must be >= 0")
    if (meta.dim() != 2 or meta.shape[1] != 2 or meta.dtype != torch.int32
            or not meta.is_contiguous()):
        raise ValueError("meta must be a contiguous (N, 2) int32 tensor, "
                         f"got {tuple(meta.shape)} {meta.dtype}")
    if meta.device.type != "cuda":
        raise ValueError(f"the CUDA probe needs CUDA tensors, got "
                         f"{meta.device}")


def launch(name: str, meta, W: int, n_diags: int, *, n_waves: int = 1,
           skewed: bool = False, ival: bool = False,
           return_state: bool = False):
    """Launch one CUDA instance on the current stream, one block of W / 8
    threads (rounded up to a warp) per pair (the caller checked its
    arguments with `check_args`), counted under `name`: (N, 4) int32,
    and with ``return_state`` the final state as `plain` returns it."""
    n = meta.shape[0]
    out = torch.empty((n, 4), dtype=torch.int32, device=meta.device)
    state = torch.empty((n, state_width(W, n_waves, skewed)),
                        dtype=torch.int32,
                        device=meta.device) if return_state else None
    if n:
        LIB.launch(
            "agatha_substep_probe", name, meta.data_ptr(), out.data_ptr(),
            state.data_ptr() if return_state else None, n, W, n_diags,
            n_waves, int(skewed), int(ival), on=meta,
        )
    return (out, state) if return_state else out


def resident_blocks(W: int, n_waves: int, skewed: bool, ival: bool) -> int:
    """Blocks of this instance the card holds at once (all SMs)."""
    def query():
        per_sm = ctypes.c_int(0)
        err = LIB.entry("agatha_substep_probe_occupancy")(
            W, n_waves, int(skewed), int(ival), ctypes.byref(per_sm))
        return _nvcc.blocks_per_sm(-err if err else per_sm.value)

    return _nvcc.resident(("probe.substep", W, n_waves, skewed, ival), query,
                          torch.cuda.current_device())


def time_ms(fn, reps: int = 8, rounds: int = 3) -> float:
    """Best of `rounds` of the mean ms of `reps` launches of fn() between
    CUDA events, after one warm-up launch (the originals' protocol)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def card_report(ms: float, meta, W: int, n_diags: int, indent: int, *,
                n_waves: int = 1, skewed: bool = False,
                ival: bool = False) -> dict:
    """Print and return a launch that took `ms` in the card's units:
    per-block ns per substep (the launch time over one block's
    substeps, divided by the rounds of blocks the card needs when it
    cannot hold them all at once) and GCUPS-equivalent (the C-true cells
    of these inputs over the launch time)."""
    n = meta.shape[0]
    resident = resident_blocks(W, n_waves, skewed, ival)
    cells = count_cells(meta, W, n_diags, n_waves=n_waves, skewed=skewed,
                        ival=ival)
    block_ns = ms * 1e6 / (8 * n_diags * max(1, -(-n // resident)))
    gcups = cells / (ms * 1e6)
    threads = (W // 8 + 31) // 32 * 32  # a tile row each, whole warps
    print(f"{'':{indent}s} card: {ms:.4f} ms a launch, {n} blocks of "
          f"{threads} threads ({W} lanes), {resident} resident at once: "
          f"{block_ns:.2f} ns per substep per block, {gcups:.3f} "
          f"GCUPS-equivalent ({cells} C-true cells)", flush=True)
    return {"ms": ms, "block_ns": block_ns, "gcups": gcups, "cells": cells,
            "blocks": n, "resident": resident}
