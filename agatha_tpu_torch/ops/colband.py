"""Banded column sweep for the long-read regime: gate, shapes, kernel.

PyTorch counterpart of `agatha_tpu.ops.colband` (the Pallas kernel
`_make_colband_kernel` with its fused chain `_vchain`, behind
`_colband_jit`).  The column sweep of `ops.colsweep` needs the band to
cover the whole DP rectangle; this module sweeps one query column at a
time through a sliding window of RW target rows that follows the band,
so it serves the banded long-read buckets the antidiagonal kernel
(`ops.kernel`) otherwise takes.

Semantics reproduced (reference agatha_kernel.h:20-47 CORE_COMPUTE,
183-186/224-253 slice/chunk/band clipping, 206-216 fake-row reloads,
291-356 Z-drop schedule + wrap-up; oracle: ops/sweep.py):

* per-cell computed predicate C(r, j): within a COLUMN j the query
  word pq = j >> 3 is constant, so the slice/chunk algebra (cs/ce
  chunk bounds, slice index i = ((pr+pq)//sw)*sw, ss/se slice clips)
  is constant per 8-column group and only the per-cell band test
  |j - r| <= bw varies per column;
* value freezing at not-computed cells: H and F are row-state carries
  committed only where C (identical to the oracle's strip-mediated
  staleness); E is column-local and rooted at top_init_e(j), passing
  FROZEN (no gap-extend decay) through not-computed rows;
* chunk-start resets (column j % 8 == 0 only, since every cell of a
  column shares qq & 7 == j & 7): fake rows reload MINUS_INF2 into the
  F / diagonal-H inputs; int16 strip truncations are identities in
  the int16-safe regime this path requires (same gate as colsweep);
* per-diagonal maxima + the exact best/Z-drop replay, including the
  empty-slice termination (agatha_kernel.h:189) which the vacuous
  colsweep regime could never reach.

E under freezing, exactly: let S(r) = #{k < r : C(k, j)} (computed
count above r).  Then

    e_in(r) = max(root, max_{k<r, C(k)} temp(k) - goe + ge*(S(k)+1))
              - ge * S(r)          with  root = top_init_e(j)

because E decays by gap_extend once per COMPUTED cell it passes and
freezes through the rest (ops/sweep.py: e_next_src = where(C, ...)).
When C(., j) is a single interval (every config tested; the
hole-detector of `align_one_colband_np` scans for counterexamples),
the device versions may use plain ge*r weights with the root carried
at the not-computed rows; the NumPy contract uses the S-weighted exact
form so the equivalence is testable.

Three implementations:

* `align_one_colband_np`: the NumPy contract, one pair, structured like
  the kernel (column loop + diagonal replay); must match ops/sweep.py
  bit for bit on every int16-safe input.
* `colband_torch`: the plain PyTorch version of the device kernel over
  (GB, RW) int32 tensors, the device kernel's arithmetic exactly (the
  plain-weight E, the three-phase window); the CPU path and the
  card-side reference.
* `csrc/colband.cu`: hand-written for Hopper, one block per pair, R
  window rows a thread (instances R = 2, 4, 8; `colband_rows` picks
  one), built with nvcc at first use and bound with ctypes.

`align_bucket_colband` dispatches on the tensors' device: CPU tensors
run `colband_torch`, CUDA tensors launch the kernel on the current
stream (or the call raises).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from agatha_tpu_torch.config import AlignConfig
from agatha_tpu_torch.constants import (
    INT32_MIN,
    MINUS_INF2,
    N_PENALTY,
    N_VALUE,
)
from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.ops.colsweep import chain_replay_torch
from agatha_tpu_torch.ops.kernel import _widen

_I64 = np.int64
_NEG = -(1 << 40)  # prefix fill; far below any live int32 DP value


def _trunc16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _i32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _ctrunc16(a):
    a = np.asarray(a, dtype=_I64)
    return np.where(a >= 0, a // 16, -((-a) // 16))


def slice_bounds_np(i, pql, prl, sw, bw):
    """(ss, se) of slice i (agatha_kernel.h:183-186 / sweep.py)."""
    ss = np.maximum(np.maximum(0, i - pql + 1), _ctrunc16(8 * i + 8 - bw))
    se = np.minimum(
        np.minimum(prl - 1, i + sw - 1),
        _ctrunc16(8 * (i + sw - 1) + 7 + bw),
    )
    return ss, se


def first_empty_slice(qlen: int, rlen: int, cfg: AlignConfig):
    """Index of the first slice with ss > se, or None.

    The reference terminates the whole job at the top of a slice whose
    row range is empty (agatha_kernel.h:189); diagonals of that slice
    and beyond are never swept.
    """
    sw, bw = cfg.slice_width, cfg.band_width
    pql = -(-qlen // 8)
    prl = -(-rlen // 8)
    tad = prl + pql - 1
    i_end = -(-tad // sw) * sw
    for islice in range(0, i_end, sw):
        ss, se = slice_bounds_np(islice, pql, prl, sw, bw)
        if int(ss) > int(se):
            return islice
    return None


def computed_col(j: int, r_idx, pr, cs, ce, pql, prl, sw, bw, qlen):
    """The oracle's computed_mask restricted to column j (all rows).

    sweep.py computed_mask with qq = j constant: valid is a per-column
    scalar, in_chunk/interior depend on (pr, pj) only, in_slice on
    (pr + pj), and the band test is the only per-cell-within-group
    term.
    """
    if not (0 <= j < qlen):
        return np.zeros(r_idx.shape, bool)
    pj = j >> 3
    i = ((pr + pj) // sw) * sw
    ss, se = slice_bounds_np(i, pql, prl, sw, bw)
    in_slice = (pr >= ss) & (pr <= se)
    in_chunk = (pj >= cs) & (pj <= ce)
    interior = (pj > cs) & (pj < ce)
    in_band = np.abs(j - r_idx) <= bw
    return in_slice & in_chunk & (interior | in_band)


def cstart_col(j: int, pr, cs, sw):
    """Chunk-start mask for column j (sweep.py chunk_start_mask).

    Every cell of column j has query-word offset qq & 7 == j & 7, so
    chunk-start cells exist only at word-aligned columns.
    """
    if j % 8 != 0:
        return np.zeros(pr.shape, bool)
    pj = j >> 3
    i = ((pr + pj) // sw) * sw
    return pj == np.maximum(cs, i - pr)


def _top_init(col, cfg):
    goe, ge, bw = cfg.gap_oe, cfg.gap_extend, cfg.band_width
    k = _trunc16(-(goe + ge * col))
    h = 0 if col < 0 else (int(k) if col <= bw else MINUS_INF2)
    e = int(_trunc16(k - goe)) if col <= bw else MINUS_INF2
    return h, e


def colband_eligible(meta: np.ndarray, cfg: AlignConfig,
                     safe16: bool) -> bool:
    """True when the banded column-sweep kernel may serve a bucket.

    Unlike colsweep there is no band-coverage requirement: the
    slice/chunk/band clipping is implemented.  Requirements:

    * the int16-safe regime (``int16_safe``): the strip truncations the
      kernel omits are identities;
    * a sliding window of RW <= 4096 rows, the JAX package's gate, kept
      so that both engines route the same buckets; it admits every
      BASELINE config including the ONT wide band (bw = 2001 ->
      RW = 4048).  At RW = 4096 one pair's shared memory in the CUDA
      kernel (the ring of 8192 diagonals and the buffer through which
      the window's rows change threads; H, F and the target codes are
      in registers) is ~67 KB, inside the 227 KB a block may use, so no
      further "fits" gate is needed (unlike `ops.colsweep.sweep_fits`).

    The plain-weight E form additionally needs every column's computed
    row set to be one contiguous interval; the length-derived clips
    can never break a column (ss's ``i - pql + 1`` term and se's
    ``prl - 1`` / ``i + sw - 1`` terms are vacuous for real columns),
    so the property is a function of (band_width, slice_width) geometry
    alone and is verified by the hole-detector scans in the tests
    across the stress config classes.
    """
    if not safe16:
        return False
    bw = cfg.band_width
    LEAD = -(-(bw + 16) // 8) * 8
    RW = -(-(LEAD + bw + 16) // 8) * 8
    return RW <= 4096


def align_one_colband_np(q_codes, t_codes, qlen, rlen, cfg: AlignConfig,
                         collect_holes: list | None = None):
    """NumPy banded column sweep of one pair; must match
    align_one_sweep on every int16-safe input.

    The semantic contract for the device kernel: column loop with
    freezing, S-weighted E prefix, diagonal ring, then the exact
    per-diagonal chain replay with the empty-slice cap.  If
    `collect_holes` is a list, every column whose computed set is NOT
    one contiguous row interval appends (j, mask) to it; the
    kernel's plain-weight E form is exact iff this never fires.
    """
    sw, bw, z = cfg.slice_width, cfg.band_width, cfg.z_threshold
    goe, ge = cfg.gap_oe, cfg.gap_extend
    pql = -(-qlen // 8)
    prl = -(-rlen // 8)
    R8 = prl * 8
    tad = prl + pql - 1
    i_end = -(-tad // sw) * sw
    n_diags = qlen + rlen - 1

    t = np.asarray(t_codes[:R8], _I64)
    q = np.asarray(q_codes[: pql * 8], _I64)
    r_idx = np.arange(R8, dtype=_I64)
    pr = r_idx >> 3
    cs = np.maximum(0, 8 * pr - bw) // 8
    ce = np.minimum(pql - 1, (8 * pr + 7 + bw) // 8)
    fake = r_idx >= rlen
    prev_fake = np.zeros(R8, bool)
    prev_fake[1:] = fake[:-1]

    def hd_init(l):
        k = _trunc16(-(goe + ge * l))
        h = np.where(l <= bw, k, MINUS_INF2)
        f = np.where(l <= bw, _trunc16(k - goe), MINUS_INF2)
        return h, f

    h_st, f_st = hd_init(r_idx)
    h_st = h_st.astype(_I64)
    f_st = f_st.astype(_I64)

    n_ring = 8 * i_end + 8
    diag_max = np.full(n_ring, INT32_MIN, dtype=_I64)

    for j in range(qlen):
        C = computed_col(j, r_idx, pr, cs, ce, pql, prl, sw, bw, qlen)
        cst = cstart_col(j, pr, cs, sw)

        if collect_holes is not None and C.any():
            nz = np.flatnonzero(C)
            if nz[-1] - nz[0] + 1 != nz.size:
                collect_holes.append((j, C.copy()))

        top_h = _top_init(j - 1, cfg)[0]
        top_e = _top_init(j, cfg)[1]

        # diagonal-H input (strip truncations are identities: this
        # path requires the int16-safe regime, like colsweep)
        htl = np.empty(R8, _I64)
        htl[1:] = h_st[:-1]
        htl[0] = top_h
        htl = np.where(cst & prev_fake, MINUS_INF2, htl)

        qb = q[j]
        s = np.where(qb == t, cfg.match, -cfg.mismatch)
        s = np.where((qb == N_VALUE) | (t == N_VALUE), -N_PENALTY, s)
        temp = htl + s

        f_in = np.where(cst & fake, MINUS_INF2, f_st)

        # E: S-weighted prefix-max (exact under freezing, see module
        # docstring); S(r) = computed count above r
        S = np.zeros(R8, _I64)
        S[1:] = np.cumsum(C[:-1])
        gv = np.where(C, temp - goe + ge * (S + 1), _NEG)
        P = np.full(R8, _NEG, _I64)
        P[1:] = np.maximum.accumulate(gv[:-1])
        e_in = np.maximum(P, top_e) - ge * S

        h_new = np.maximum(np.maximum(temp, f_in), e_in)
        f_st = np.where(C, np.maximum(temp - goe, f_in - ge), f_in)
        h_st = np.where(C, h_new, h_st)

        packed = _i32((h_new << 16) + r_idx)
        packed = np.where(C, packed, INT32_MIN)
        d = r_idx + j
        np.maximum.at(diag_max, d, packed)

    islice0 = first_empty_slice(qlen, rlen, cfg)
    return diag_chain_banded_np(
        diag_max, i_end, n_diags, islice0, sw, z, ge
    )


def diag_chain_banded_np(diag_max, i_end, n_diags, islice0, sw, z, ge):
    """Per-diagonal best/Z-drop replay with the empty-slice cap.

    Matches sweep.py's slice loop + wrap-up: diagonals of the first
    empty slice (and beyond) are never swept (the job terminates at
    that slice's top without counting them) and the 8 wrap-up
    diagonals run unguarded only when no slice terminated early.
    Returns (score, q_end, t_end, diags_swept).
    """
    ms, mr, mq = 0, 0, 0
    diags = 0
    i_end8 = 8 * i_end
    cap = i_end8 + 8 if islice0 is None else 8 * islice0
    for d in range(min(i_end8 + 8, cap)):
        diags += 1
        gate = (d < i_end8 and d < n_diags) or (d >= i_end8)
        if not gate:
            continue
        dmax = int(diag_max[d])
        th = dmax >> 16
        tr = dmax & 0xFFFF
        if th > ms:
            ms, mr, mq = th, tr, d - tr
        elif tr >= mr and (d - tr) >= mq:
            gap = abs((tr - mr) - ((d - tr) - mq))
            if z >= 0 and ms - th > z + gap * ge:
                break
    return ms, mq, mr, diags


def colband_shapes(meta, cfg: AlignConfig):
    """Static kernel extents + phase schedule for a bucket.

    Returns (RW, R8pad, Qpad, G, gA, gB, tail_steps, LEAD, WMAX).
    Extents round to 256-row/col steps, as the JAX package rounds them
    (rounded-out columns are masked by qlen; rounded-out rows never
    pass the in_slice clip).

    Window margins: per column j of group g, computed rows satisfy
    8g - bw - 14 <= r <= 8g + bw + 14, so LEAD = round8(bw+16) keeps
    the window top above every live row and RW = round8(LEAD+bw+16)
    keeps the bottom below.  The window origin of group g is
    w0(g) = clip(8g - LEAD, 0, WMAX): pinned at the top before group
    gA, rolling 8 rows a group until gB, pinned at the bottom after.
    A Python simulation of the group loop asserts the ring/consumption
    invariants: diagonals below w0(g) + 8g - 8 are final after group g,
    and RW + 16 live ring entries suffice.
    """
    bw, sw = cfg.band_width, cfg.slice_width
    meta = np.asarray(meta)
    qmax = int(meta[:, 0].max())
    rmax = int(meta[:, 1].max())
    Qpad = -(-max(qmax, 8) // 256) * 256
    R8pad = -(-max(rmax, 8) // 256) * 256
    LEAD = -(-(bw + 16) // 8) * 8
    RW = min(-(-(LEAD + bw + 16) // 8) * 8, R8pad)
    WMAX = R8pad - RW
    G = Qpad // 8
    # first rolling group / first bottom-pinned group
    gA = min(LEAD // 8 + 1, G)
    gB = min((WMAX + LEAD) // 8 + 1, G) if WMAX > 0 else gA
    gB = max(gB, gA)
    # bucket-max total diagonals incl. wrap-up (i_end8 + 8)
    pql = -(-qmax // 8)
    prl = -(-rmax // 8)
    i_end8_max = 8 * (-(-(pql + prl - 1) // sw) * sw)
    d0_last = int(np.clip(8 * (G - 1) - LEAD, 0, WMAX)) + 8 * (G - 1) - 8
    tail_steps = max(0, -(-(i_end8_max + 8 - d0_last) // 16))

    # invariant simulation of the kernel's consumption schedule:
    # group g consumes c(g) = 16 in the rolling phase else 8, from
    # d0(g-1) = w0(g-1) + 8(g-1) - 8 (g=0 consumes 8 never-written
    # lead-in rows with d < 0, harmless by the chain's d>=0 guards);
    # writes land at ring rows rw + k + 8 and must stay inside RW+16.
    ring = RW + 16
    d0_prev = -16
    for g in range(G):
        w0 = min(max(8 * g - LEAD, 0), WMAX)
        d0 = w0 + 8 * g - 8
        c = 16 if gA <= g < gB else 8
        assert d0 - d0_prev == c, (g, d0 - d0_prev, c)
        # writes this group: ring rows [8, hi_w]
        hi_w = (RW - 1) + 7 + (w0 + 8 * g) - d0
        assert 8 <= hi_w < ring, (g, hi_w)
        d0_prev = d0
    assert d0_prev == d0_last
    assert d0_last + 16 * tail_steps >= i_end8_max + 8
    return RW, R8pad, Qpad, G, gA, gB, tail_steps, LEAD, WMAX


def chain_scalars(meta: np.ndarray, cfg: AlignConfig) -> np.ndarray:
    """(8, GB) per-pair chain gates: qlen, rlen, i_end8, n_diags,
    end_p (= i_end8+8 capped at the first empty slice x 8).

    The empty-slice scan vectorizes across pairs: slice i is empty for
    a pair iff ss(i) > se(i) (slice_bounds_np), and the cap is the
    first such i (agatha_kernel.h:189).
    """
    sw, bw = cfg.slice_width, cfg.band_width
    meta = np.asarray(meta, _I64)
    qlen = meta[:, 0]
    rlen = meta[:, 1]
    pql = -(-qlen // 8)
    prl = -(-rlen // 8)
    tad = pql + prl - 1
    i_end = -(-tad // sw) * sw
    i_end8 = 8 * i_end
    n_diags = qlen + rlen - 1
    end_p = i_end8 + 8
    gb = meta.shape[0]
    i_max = int(i_end.max()) if gb else 0
    if i_max:
        # vectorized first-empty-slice scan: (S, GB) slice grid in one
        # pass (a per-slice Python loop would serialize every dispatch)
        isl = np.arange(0, i_max, sw, dtype=_I64)[:, None]
        ss, se = slice_bounds_np(isl, pql[None, :], prl[None, :],
                                 sw, bw)
        empty = (isl < i_end[None, :]) & (ss > se)
        any_e = empty.any(axis=0)
        first = empty.argmax(axis=0)
        end_p = np.where(any_e, 8 * isl[first, 0], end_p)
    out = np.zeros((8, gb), np.int32)
    out[0] = qlen
    out[1] = rlen
    out[2] = i_end8
    out[3] = n_diags
    out[4] = end_p
    return out


# --- the plain PyTorch version of the device kernel -----------------------

# E-scan fill: loses every max and cannot wrap around.
_NEG_BIG = -(1 << 28)


def _ctr16(t):
    """C-style truncation of t / 16 over a tensor."""
    return torch.where(t >= 0, t >> 4, -((-t) >> 4))


def _shift_up(x, s: int, fill: int):
    """Columns [:-s] = x[:, s:], the last s columns = fill."""
    return torch.cat([x[:, s:], x.new_full((x.shape[0], s), fill)], dim=1)


def _wrap32(x):
    """An int64 tensor wrapped to int32 as two's-complement arithmetic."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def colband_torch(scalars, tcodes, qfwd, cfg: AlignConfig,
                  shapes) -> torch.Tensor:
    """Plain PyTorch version of the banded column-sweep kernel.

    A transcription of the Pallas `_make_colband_kernel` over (GB, RW)
    int32 tensors on any device, any GB: the window origin
    w0(g) = clip(8g - LEAD, 0, WMAX) with H, F and target codes shifted
    up 8 rows where it moves, the per-group mask algebra, top_h at
    window row 0, chunk-start reloads at k == 0 only, the plain-weight
    E prefix maximum with the root carried at not-computed rows, commits
    only where C, (h_new << 16) + r_abs wrapped to int32.  The diagonal
    maxima go to a whole (GB, D) array instead of a ring consumed 8 or
    16 diagonals a group: every diagonal is final before the chain
    reads it either way, so the replay sees the same values.  The
    replay is `diag_chain_banded_np` with every pair at once and the
    per-pair gates of `chain_scalars` (`ops.colsweep.chain_replay_torch`);
    the Pallas `_vchain` computes it by a prefix argmax over 16
    diagonals at a time, and since the running best is a strictly
    improving argmax the serial replay gives the same state.

    scalars is the (8, GB) int32 tensor of `chain_scalars`, tcodes and
    qfwd the nibble wire, shapes the tuple of `colband_shapes`.
    Returns (GB, 4) int32 [score, query_end, target_end, diagonals].
    """
    RW, R8pad, Qpad, G, _gA, _gB, _tail, LEAD, WMAX = shapes
    sw, bw = cfg.slice_width, cfg.band_width
    goe, ge = cfg.gap_oe, cfg.gap_extend
    dev = scalars.device
    i32 = torch.int32
    gb = scalars.shape[1]

    def padt(x, n):
        if x.shape[1] < n:
            return torch.cat(
                [x, x.new_zeros((gb, n - x.shape[1]))], dim=1)
        return x[:, :n]

    tmat = padt(_widen(tcodes), R8pad)
    qmat = padt(_widen(qfwd), Qpad)
    qlen = scalars[0][:, None]
    rlen = scalars[1][:, None]
    pql = (qlen + 7) >> 3
    prl = (rlen + 7) >> 3

    rw_i = torch.arange(RW, dtype=i32, device=dev)[None, :]
    ge_rw = ge * rw_i
    k0 = -(goe + ge_rw)
    hp = torch.where(rw_i <= bw, k0, MINUS_INF2).expand(gb, RW).contiguous()
    fi = torch.where(rw_i <= bw, k0 - goe,
                     MINUS_INF2).expand(gb, RW).contiguous()
    tmw = tmat[:, :RW].contiguous()
    # the chain runs to end_p (up to i_end8 + 8), which can pass the
    # padded extent R8pad + Qpad; the diagonals past it hold INT32_MIN
    end_max = int(scalars[4].max()) if gb else 0
    n_diag = max(R8pad + Qpad, end_max)
    diag = torch.full((gb, n_diag), INT32_MIN, dtype=i32, device=dev)

    w0_prev = 0
    for g in range(G):
        w0 = min(max(8 * g - LEAD, 0), WMAX)
        if w0 != w0_prev:
            hp = _shift_up(hp, 8, MINUS_INF2)
            fi = _shift_up(fi, 8, MINUS_INF2)
            tmw = tmat[:, w0:w0 + RW]
        w0_prev = w0

        # per-group mask algebra (pj == g)
        r_abs = rw_i + w0
        pr = r_abs >> 3
        cs = torch.clamp((pr << 3) - bw, min=0) >> 3
        ce = torch.minimum(pql - 1, ((pr << 3) + 7 + bw) >> 3)
        i_sl = torch.div(pr + g, sw, rounding_mode="floor") * sw
        ss = torch.maximum(torch.clamp(i_sl - pql + 1, min=0),
                           _ctr16((i_sl << 3) + (8 - bw)))
        se = torch.minimum(torch.minimum(prl - 1, i_sl + (sw - 1)),
                           _ctr16((i_sl << 3) + (8 * (sw - 1) + 7 + bw)))
        insl = (pr >= ss) & (pr <= se)
        xg = insl & (g >= cs) & (g <= ce)
        yg = insl & (g > cs) & (g < ce)
        cst = g == torch.maximum(cs, i_sl - pr)
        cst_f = cst & (r_abs >= rlen)
        cst_pf = cst & (r_abs >= rlen + 1)
        t_is_n = tmw == N_VALUE
        sub_m = torch.where(t_is_n, -N_PENALTY, cfg.match)
        sub_x = torch.where(t_is_n, -N_PENALTY, -cfg.mismatch)

        for k in range(8):
            j = 8 * g + k
            colm = qlen > j
            band = (r_abs >= j - bw) & (r_abs <= j + bw)
            C = (yg | (xg & band)) & colm

            qb = qmat[:, j:j + 1]
            s = torch.where(qb == tmw, sub_m, sub_x)
            s = torch.where(qb == N_VALUE, -N_PENALTY, s)

            top_h = 0 if j == 0 else (
                -(goe + ge * (j - 1)) if j - 1 <= bw else MINUS_INF2)
            top_e = -(goe + ge * j) - goe if j <= bw else MINUS_INF2

            htl = torch.cat([hp.new_full((gb, 1), top_h), hp[:, :-1]],
                            dim=1)
            f_in = fi
            if k == 0:  # chunk starts live at j % 8 == 0 only
                htl = torch.where(cst_pf, MINUS_INF2, htl)
                f_in = torch.where(cst_f, MINUS_INF2, f_in)
            temp = htl + s

            # E: plain-weight prefix maximum; not-computed rows carry
            # the root, which so decays once per computed row it passes
            gv = ge_rw + torch.where(C, temp - goe, top_e)
            p = torch.cat([gv.new_full((gb, 1), top_e - ge), gv[:, :-1]],
                          dim=1)
            p = torch.cummax(p, dim=1).values
            e_in = p - (ge_rw - ge)

            h_new = torch.maximum(torch.maximum(temp, f_in), e_in)
            f_new = torch.maximum(gv - ge_rw, f_in - ge)
            fi = torch.where(C, f_new, f_in)
            hp = torch.where(C, h_new, hp)

            packed = _wrap32((h_new.to(torch.int64) << 16) + r_abs)
            packed = torch.where(C, packed, INT32_MIN)
            d0 = w0 + j
            diag[:, d0:d0 + RW] = torch.maximum(diag[:, d0:d0 + RW], packed)
    return chain_replay_torch(diag.t().contiguous(), scalars[2], scalars[3],
                              scalars[4], cfg)


# --- the CUDA kernel: signatures, launch ----------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _nvcc.Library("colband.cu", {
    "agatha_colband": ([_vp] * 4 + [_ci] * 15 + [_vp, _ci, _vp], _ci),
    "agatha_colband_probe": ([_vp] * 4 + [_ci] * 8 + [_vp], _ci),
})
# Rows a thread of the B7 instances (csrc/colband.cu colband_kernel<R>).
COLBAND_ROWS = (2, 4, 8)
# Row threads a block of the instance `colband_rows` picks may have.
COLBAND_ROW_THREADS = 384


def colband_rows(RW: int) -> int:
    """Rows a thread R of the B7 instance a window of RW rows takes.

    A block is RW / R row threads, rounded up to warps, and the chain
    warp, within the instance's `max_threads`: R = 2 fits up to RW
    1984, R = 4 up to 1536, R = 8 every window (the gate's 4096).  The
    rule: the fewest rows a
    thread that keep RW / R within 384 row threads (12 row warps), else
    8.  On the H100 (probes/colband_bench.py, 1024 x 10 kb at bands 127,
    255, 751, 1000 and 2001; PERF.md §6) the rule's instance was the
    fastest at bands 255-2001 (R = 2 at RW 544, 9 warps; R = 4 at RW
    1536, 12; R = 8 at RW 2032, 8) and 0.7% behind R = 4 at bw 127 (RW
    288: R = 2 3.216 ms, R = 4 3.195); fewer warps hide less of a
    column's latency, more pay more at its two barriers and scan than
    they hide.  Only RW 1536 is a benchmark cell's window: the R = 2
    and R = 8 sides of the rule rest on that probe workload alone.
    """
    for R in COLBAND_ROWS:
        if -(-RW // R) <= COLBAND_ROW_THREADS:
            return R
    return COLBAND_ROWS[-1]


def max_threads(rows: int) -> int:
    """Threads a block of the B7 instance of `rows` rows a thread may
    have: its launch bound, csrc/colband.cu's colband_max_threads (R = 4
    bound by the largest block `colband_rows` gives it)."""
    if rows == 4:
        return COLBAND_ROW_THREADS + 32
    return min(4096 // rows + 32, 1024)


def block_threads(RW: int, rows: int) -> int:
    """Threads of a B7 block at RW window rows, `rows` a thread."""
    return -(-(RW // rows) // 32) * 32 + 32


def _check_wire(scalars, tcodes, qfwd, gb):
    for name, x in (("tcodes", tcodes), ("qfwd", qfwd)):
        if x.dim() != 2 or x.shape[0] != gb:
            raise ValueError(f"{name} must be (GB, X) with GB={gb}, "
                             f"got {tuple(x.shape)}")
        if x.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 nibbles, got {x.dtype}")
        if x.shape[1] % 4:
            raise ValueError(f"{name} must hold a multiple of 8 codes, "
                             f"got {2 * x.shape[1]}")
    if (scalars.dim() != 2 or scalars.shape != (8, gb)
            or scalars.dtype != torch.int32):
        raise ValueError(f"scalars must be (8, {gb}) int32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    _nvcc.check(("scalars", scalars), ("tcodes", tcodes), ("qfwd", qfwd))


def _check_shapes(shapes, cfg: AlignConfig):
    """`shapes` must be a schedule `colband_shapes` can return: the
    window inside the padded rows, whole 8-row blocks, the gate's RW
    bound, and row-block sums inside the range where the kernels'
    slice index is exact."""
    RW, R8pad, Qpad, G, _gA, _gB, _tail, LEAD, WMAX = shapes
    ok = (RW > 0 and RW % 8 == 0 and RW <= 4096 and R8pad % 8 == 0
          and Qpad == 8 * G and WMAX == R8pad - RW and WMAX >= 0
          and LEAD % 8 == 0 and LEAD >= cfg.band_width + 16
          and (RW == R8pad or RW >= LEAD + cfg.band_width + 16)
          and (R8pad + Qpad) // 8 < 1 << 15)
    if not ok:
        raise ValueError(f"shapes {tuple(shapes)} are not a colband "
                         f"schedule for band {cfg.band_width}")


def colband_cuda(scalars, tcodes, qfwd, cfg: AlignConfig, shapes, *,
                 rows: int | None = None) -> torch.Tensor:
    """Launch the B7 kernel on the current stream; (GB, 4) int32.

    One block per pair; rows and columns past the wire read as code 0.
    `rows` picks the instance of that many window rows a thread (2, 4 or
    8; `colband_rows(RW)` when None).  Does not synchronise.  Raises if
    the instance cannot take the window, or the build or the launch
    fails.
    """
    gb = scalars.shape[1] if scalars.dim() == 2 else -1
    _check_wire(scalars, tcodes, qfwd, gb)
    _check_shapes(shapes, cfg)
    RW, _R8pad, Qpad, _G, _gA, _gB, _tail, LEAD, WMAX = shapes
    if rows is None:
        rows = colband_rows(RW)
    if rows not in COLBAND_ROWS or block_threads(RW, rows) > max_threads(
            rows):
        raise ValueError(f"no B7 instance of {rows} rows a thread takes "
                         f"a window of {RW} rows")
    out = torch.empty((gb, 4), dtype=torch.int32, device=scalars.device)
    if gb == 0:
        return out
    LIB.launch(
        "agatha_colband", f"colband.r{rows}",
        scalars.data_ptr(), tcodes.data_ptr(), qfwd.data_ptr(),
        out.data_ptr(), gb, 2 * tcodes.shape[1], 2 * qfwd.shape[1],
        RW, Qpad, LEAD, WMAX,
        cfg.match, cfg.mismatch, cfg.gap_oe, cfg.gap_extend,
        cfg.slice_width, cfg.z_threshold, cfg.band_width,
        rows, None, on=scalars,
    )
    return out


def align_bucket_colband(meta, tcodes, qfwd, cfg: AlignConfig, *,
                         shapes=None, scalars=None) -> torch.Tensor:
    """Banded column-sweep alignment of one bucket (align_bucket's
    contract).

    Args:
      meta, tcodes, qfwd: the bucket wire as for `ops.kernel.align_bucket`
        ((GB, 2) int32, (GB, W/2) and (GB, QF/2) uint8 nibbles); any GB.
      cfg: alignment parameters.  The caller has checked the int16-safe
        gate (`colband_eligible`).
      shapes: `colband_shapes` of the host meta.
      scalars: the (8, GB) int32 tensor of `chain_scalars`, on meta's
        device.  Either is computed here when omitted, which copies a
        CUDA meta to the host and so synchronises; the engine passes
        both.

    CUDA tensors launch the kernel on the current stream without
    synchronising, or the call raises; CPU tensors run `colband_torch`.
    Returns (GB, 4) int32 [score, query_end, target_end,
    diagonals_swept] on the input device, bit-identical to align_bucket.
    """
    if meta.dim() != 2 or meta.shape[1] != 2 or meta.dtype != torch.int32:
        raise ValueError(f"meta must be (GB, 2) int32, got "
                         f"{tuple(meta.shape)} {meta.dtype}")
    gb = meta.shape[0]
    if shapes is None or scalars is None:
        host = meta.cpu().numpy()
        if shapes is None and gb:
            shapes = colband_shapes(host, cfg)
        if scalars is None:
            scalars = torch.from_numpy(chain_scalars(host, cfg)).to(
                meta.device)
    _check_wire(scalars, tcodes, qfwd, gb)
    if gb == 0:
        return torch.empty((0, 4), dtype=torch.int32, device=meta.device)
    _check_shapes(shapes, cfg)
    if meta.device.type == "cuda":
        return colband_cuda(scalars, tcodes, qfwd, cfg, shapes)
    if meta.device.type != "cpu":
        raise ValueError(f"unsupported device {meta.device}")
    return colband_torch(scalars, tcodes, qfwd, cfg, shapes)
