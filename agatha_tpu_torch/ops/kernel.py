"""Antidiagonal alignment of one bucket: geometry, wire format, kernel.

PyTorch counterpart of `agatha_tpu.ops.kernel` (the Pallas kernel
`_make_kernel` and its `align_bucket` entry).  The contract is the
JAX package's: (GB, 2) int32 [qlen, rlen] plus 4-bit codes in, (GB, 4)
int32 [score, query_end, target_end, diagonals_swept] out, bit-identical
to `agatha_tpu.ops.sweep.align_one_sweep`.

Two implementations of one function:

* `align_bucket_torch`: the plain version, a direct transcription of
  the Pallas substep over (GB, W_state) tensors.  The CPU path and the
  card-side reference for the kernel.
* `csrc/antidiag.cu`: the hand-written Hopper kernel (one thread block
  per pair, one 8x8 tile per thread and packed diagonal), built with
  nvcc at first use and bound with ctypes.

`align_bucket` dispatches on the tensors' device: CPU tensors take the
plain version, CUDA tensors the kernel (or the call raises).

With ``emit_flags`` both also write the traceback bitmap of the JAX
package's emit-flags variant: (GB, planes * W_state) int32, plane D
(packed diagonal D, base diagonals 8D..8D+7) at lanes [D*W_state,
(D+1)*W_state), lane = row - vbase, one 4-bit nibble per cell at bits
4k for substep k (nibble convention: ops/walk.py).

The plain version keeps the Pallas kernel's sliding-window schedule (the
`vbase` decision every 64 base diagonals); the kernel computes the same
cells over tiles and keeps the schedule for the bitmap's lanes only.
Their outputs are equal; their bitmaps are equal on every computed
cell, the only nibbles the walk reads (the kernel leaves the others
unwritten or not the plain version's).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from agatha_tpu_torch import trace
from agatha_tpu_torch.config import AlignConfig
from agatha_tpu_torch.constants import (
    INT32_MIN,
    MINUS_INF2,
    N_PENALTY,
    N_VALUE,
)
from agatha_tpu_torch.ops import _nvcc

# Lane tile: bucket widths (W) and query widths (QF) are multiples.
LANE = 128
# Bucket row counts are multiples of this (the JAX program height).
B_PAIRS = 8
# Window shift quantum and the INNER_ITERS packed diagonals between two
# shift decisions (kernel.py:145-153 of the JAX package).
SHIFT_Q = LANE
INNER_ITERS = 8
# Out-of-band rows that may still hold computed cells, and the shift
# guard (>= SLOP so a shift never overruns the lowest needed row).
SLOP = 24
GUARD = 32


def int16_safe(cfg: AlignConfig, max_len: int) -> bool:
    """True when no live DP value can leave int16 range.

    Then the reference's int16 strip round-trips are identities and the
    kernel may skip them.  Same bound as the JAX package: positive
    scores <= match * max_len; negative decay bounded through Z-drop.
    With z < 0 the reference's int16 wraparound is observable.
    """
    if cfg.z_threshold < 0:
        return False
    if cfg.match * max_len >= 32000:
        return False
    decay = (
        16384
        + cfg.z_threshold
        + (2 * cfg.band_width + 64) * cfg.gap_extend
        + 8 * cfg.slice_width * (cfg.mismatch + cfg.gap_oe + cfg.gap_extend)
        + 1024
    )
    return decay < 32768


def window_width(cfg: AlignConfig) -> int:
    """Row width of the sliding-window state for this config.

    bw + 4*INNER_ITERS + 4 + SLOP + GUARD + SHIFT_Q = bw + 220 rows are
    needed, strictly more for the query-window healing margin, rounded
    up to the lane tile: 1024 at the canonical bw = 751.
    """
    need = cfg.band_width + 4 * INNER_ITERS + 4 + SLOP + GUARD + SHIFT_Q
    return -(-(need + 1) // LANE) * LANE


def tile_threads(cfg: AlignConfig, wt: int) -> int:
    """Threads of the tile kernel for a bucket of width wt: one per tile
    row of the widest range it processes at one packed diagonal.

    The range runs from the row above the first row computed one step
    earlier to the last row computed two steps later; the chunk bounds
    cs = pr - c, ce = pr + c (c = ceil(bw / 8)) keep it within c + 3
    tile rows, and a bucket has wt / 8.  Rounded up to a warp.
    """
    rows = min(((7 + cfg.band_width) >> 3) + 3, wt // 8)
    return max(32, -(-rows // 32) * 32)


# The kernel's block size limit: bands past ~8150 need more tile rows.
MAX_THREADS = 1024


def b_pairs_for_width(w: int, windowed: bool = False) -> int:
    """Bucket row granularity for width w (the JAX program height).

    Kept so that buckets pad to the same row counts as the JAX
    engine's; the CUDA kernel itself runs one block per pair.
    """
    if windowed:
        return B_PAIRS
    return max(8, min(64, (8192 // w // 8) * 8))


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """Host side of the nibble wire format; codes.shape[1] must be even.

    Two 4-bit codes per byte, low nibble first.
    """
    c = codes.astype(np.uint8)
    return (c[:, 0::2] | (c[:, 1::2] << 4)).astype(np.uint8)


def build_bucket_arrays(
    pairs: list[tuple[np.ndarray, np.ndarray, int, int]],
    cfg: AlignConfig,
    *,
    w: int | None = None,
    qf: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack (q_codes, t_codes, qlen, rlen) tuples into a bucket's wire.

    Returns meta (GB, 2) int32 [qlen, rlen] and the nibble-packed
    tcodes (GB, W/2) and qfwd (GB, QF/2) uint8, padded with dummy 1x1
    pairs to the row granularity.  W and QF default to the longest
    padded target / query rounded up to the lane tile (QF >= 384).
    """
    max_w = max((-(-rl // 8) * 8 for _qc, _tc, _ql, rl in pairs), default=0)
    max_q = max((-(-ql // 8) * 8 for _qc, _tc, ql, _rl in pairs), default=0)
    if w is None:
        w = -(-max_w // LANE) * LANE
    if qf is None:
        # >= 3 lane tiles, as the JAX kernel's query staging requires
        qf = max(3 * LANE, -(-max_q // LANE) * LANE)
    if w < max_w or qf < max_q:
        raise ValueError(f"W={w} / QF={qf} narrower than the longest "
                         f"target {max_w} / query {max_q}")
    unit = b_pairs_for_width(w, w > window_width(cfg))
    gb = -(-len(pairs) // unit) * unit
    meta = np.ones((gb, 2), np.int32)
    tcodes = np.zeros((gb, w), np.uint8)
    qfwd = np.zeros((gb, qf), np.uint8)
    for p, (qc, tc, ql, rl) in enumerate(pairs):
        meta[p] = (ql, rl)
        tcodes[p, : len(tc)] = tc
        qfwd[p, : len(qc)] = qc
    return meta, pack_nibbles(tcodes), pack_nibbles(qfwd)


def flag_planes_needed(meta: np.ndarray, cfg: AlignConfig) -> int:
    """Flag planes of an emit-flags bucket: its packed diagonals + slack.

    The JAX package's count (kernel.py `flag_planes_needed`): the last
    swept plane of the longest pair plus 16, rounded up to a multiple of
    256, so the move words have the JAX shape.
    """
    meta = np.asarray(meta)
    pql = -(-meta[:, 0] // 8)
    prl = -(-meta[:, 1] // 8)
    sw = cfg.slice_width
    i_end = -(-(pql + prl - 1) // sw) * sw
    need = int(i_end.max()) + 1 + 16
    return -(-need // 256) * 256


def _widen(codes: torch.Tensor) -> torch.Tensor:
    """Nibble wire (GB, X/2) uint8 -> (GB, X) int32 codes, low first."""
    a = codes.to(torch.int32)
    return torch.stack([a & 0xF, a >> 4], dim=-1).reshape(codes.shape[0], -1)


def _bucket_geometry(tcodes, qfwd, cfg, force_strips):
    """(wt, qf, w_state, windowed, safe16) of a bucket's wire tensors."""
    wt = 2 * tcodes.shape[1]
    qf = 2 * qfwd.shape[1]
    if wt % LANE or qf % LANE:
        raise ValueError(f"widths must be multiples of {LANE}: W={wt} QF={qf}")
    windowed = wt > window_width(cfg)
    w_state = window_width(cfg) if windowed else wt
    # wt + qf bounds the longest pair for the int16-safety bound
    safe16 = (not force_strips) and int16_safe(cfg, max_len=wt + qf)
    return wt, qf, w_state, windowed, safe16


def _trunc16(x):
    """int16 wraparound (short2 strip storage) of an int or a tensor."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _ctrunc16(t: int) -> int:
    """C-style truncation of t/16 (Python's // floors)."""
    return t >> 4 if t >= 0 else -((-t) >> 4)


def align_bucket_torch(
    meta: torch.Tensor,
    tcodes: torch.Tensor,
    qfwd: torch.Tensor,
    cfg: AlignConfig,
    *,
    force_strips: bool = False,
    emit_flags: bool = False,
    planes: int | None = None,
    return_mask: bool = False,
):
    """Plain PyTorch version of the antidiagonal kernel (any device).

    A transcription of the Pallas substep (agatha_tpu/ops/kernel.py
    `_inner`) over (GB, W_state) int32 tensors: H(d-1)/H(d-2), E and F
    per row, `torch.roll` for the one-row shifts, the same masks, the
    same window schedule.  The query is gathered per substep instead of
    rolled through a window; the two differ only on cells that are not
    computed.  Returns (GB, 4) int32 on the input device, and with
    ``emit_flags`` also the (GB, planes * W_state) int32 flag bitmap
    (planes default: `flag_planes_needed`; planes never swept are 0).
    ``return_mask`` (with ``emit_flags``) adds a third tensor of the
    bitmap's layout holding nibble 0xF where the cell is computed (C)
    and 0 elsewhere: the cells whose nibbles the walk may read.
    """
    if return_mask and not emit_flags:
        raise ValueError("return_mask needs emit_flags")
    wt, qf, W, windowed, safe16 = _bucket_geometry(
        tcodes, qfwd, cfg, force_strips
    )
    dev = meta.device
    i32 = torch.int32
    sw, bw, z = cfg.slice_width, cfg.band_width, cfg.z_threshold
    goe, ge = cfg.gap_oe, cfg.gap_extend
    t_all = _widen(tcodes)
    q_all = _widen(qfwd)
    gb = t_all.shape[0]
    flags = None
    if emit_flags:
        if planes is None:
            planes = flag_planes_needed(meta.cpu().numpy(), cfg)
        flags = torch.zeros((gb, planes * W), dtype=i32, device=dev)
    cmask = torch.zeros_like(flags) if return_mask else None

    def result(out):
        if return_mask:
            return out, flags, cmask
        return (out, flags) if emit_flags else out

    if gb == 0:
        return result(torch.empty((0, 4), dtype=i32, device=dev))

    qlen = meta[:, 0:1].to(i32)
    rlen = meta[:, 1:2].to(i32)
    pql = (qlen + 7) >> 3
    prl = (rlen + 7) >> 3
    n_diags = qlen + rlen - 1
    tad = prl + pql - 1
    i_end = torch.div(tad + (sw - 1), sw, rounding_mode="floor") * sw
    i_end8 = i_end << 3
    end_p = i_end8 + 8

    def slice_bounds(i: int):
        # banded slice clipping (agatha_kernel.h:183-186)
        ss = torch.clamp(i - pql + 1, min=max(0, _ctrunc16(8 * i + 8 - bw)))
        se = torch.clamp(
            prl - 1,
            max=min(i + sw - 1, _ctrunc16(8 * i + 8 * (sw - 1) + 7 + bw)),
        )
        return ss, se

    def strip16(x):
        return x if safe16 else _trunc16(x)

    def top_h(col: int) -> int:
        if col < 0:
            return 0
        return _trunc16(-(goe + ge * col)) if col <= bw else MINUS_INF2

    def top_e(col: int) -> int:
        if col > bw:
            return MINUS_INF2
        return _trunc16(_trunc16(-(goe + ge * col)) - goe)

    def boundary_init(r):
        kb = _trunc16(-(goe + ge * r))
        in_b0 = r <= bw
        h0 = torch.where(in_b0, kb, MINUS_INF2)
        f0 = torch.where(in_b0, _trunc16(kb - goe), MINUS_INF2)
        return h0, f0

    lane = torch.arange(W, dtype=i32, device=dev)[None, :]
    lane0 = lane == 0
    h0, f0 = boundary_init(lane)
    hf1 = h0.expand(gb, W).clone()   # H(d-1)
    hf2 = hf1.clone()                # H(d-2)
    fst = f0.expand(gb, W).clone()   # F input
    est = torch.full((gb, W), MINUS_INF2, dtype=i32, device=dev)  # E input

    zeros = torch.zeros((gb, 1), dtype=i32, device=dev)
    ms, mr, mq, term, diags = (zeros.clone() for _ in range(5))

    vbase = 0
    d8 = 0
    while bool(((term == 0) & (d8 < end_p)).any()):
        # --- window decision at the half start (kernel.py:324-332) ---
        if windowed:
            want = (((d8 - bw) >> 1) - GUARD - vbase >= SHIFT_Q
                    and vbase + SHIFT_Q <= wt - W)
            if want:
                vbase += SHIFT_Q
                inc = lane >= W - SHIFT_Q
                h0n, f0n = boundary_init(vbase + lane)

                def shl(x, init):
                    return torch.where(inc, init, torch.roll(x, -SHIFT_Q, 1))

                hf1 = shl(hf1, h0n)
                hf2 = shl(hf2, h0n)
                fst = shl(fst, f0n)
                est = shl(est, torch.full_like(est, MINUS_INF2))
        # --- per-window invariants ---
        r = vbase + lane
        pr = r >> 3
        ro = r & 7
        blk_first = ro == 0
        cs = torch.clamp((pr << 3) - bw, min=0) >> 3
        ce = torch.minimum(pql - 1, ((pr << 3) + (7 + bw)) >> 3)
        fake = r >= rlen
        prev_fake = r > rlen
        tb = t_all[:, vbase:vbase + W]
        t_is_n = tb == N_VALUE
        at0 = vbase == 0

        for _ in range(INNER_ITERS):
            D = d8 >> 3
            i1 = (D // sw) * sw
            kph = D - i1
            i2 = i1 - sw if kph == 0 else i1
            pq_a = D - pr
            pq_b = pq_a - 1
            ss1, se1 = slice_bounds(i1)
            ss2, se2 = slice_bounds(i2)
            x_a = (pr >= ss1) & (pr <= se1) & (pq_a >= cs) & (pq_a <= ce)
            x_b = (pr >= ss2) & (pr <= se2) & (pq_b >= cs) & (pq_b <= ce)
            y_a = x_a & (pq_a > cs) & (pq_a < ce)
            y_b = x_b & (pq_b > cs) & (pq_b < ce)
            cse_a = pq_a == torch.maximum(cs, i1 - pr)

            # empty-slice termination, substep 0 of slice starts
            if kph == 0:
                ss_sl, se_sl = slice_bounds(D)
                term = torch.where(
                    (term == 0) & (d8 < i_end8) & (ss_sl > se_sl), 1, term
                )

            acc = torch.zeros((gb, W), dtype=i32, device=dev)
            cm = torch.zeros((gb, W), dtype=i32, device=dev)
            for k in range(8):
                d = d8 + k
                cls = ro > k
                qq = d - r
                valid = (qq >= 0) & (qq < qlen)
                in_band = (d - 2 * r).abs() <= bw
                z_a = y_a | (x_a & in_band)
                z_b = y_b | (x_b & in_band)
                C = valid & torch.where(cls, z_b, z_a)
                cst = (ro == k) & (qq >= 0) & cse_a

                top_h_v = top_h(d - 1) if at0 else MINUS_INF2
                top_e_v = top_e(d) if at0 else MINUS_INF2

                # diagonal-H input with strip round-trip / fake reload
                htl = torch.where(lane0, top_h_v, torch.roll(hf2, 1, 1))
                if not safe16:
                    htl = torch.where(blk_first | cst, _trunc16(htl), htl)
                htl = torch.where(cst & prev_fake, MINUS_INF2, htl)
                e_in = torch.where(blk_first, strip16(est), est)
                e_in = torch.where(lane0, top_e_v, e_in)
                f_in = torch.where(cst, strip16(fst), fst)
                f_in = torch.where(cst & fake, MINUS_INF2, f_in)

                qc = q_all.gather(1, qq.clamp(0, qf - 1).expand(gb, W))
                s = torch.where(qc == tb, cfg.match, -cfg.mismatch)
                s = torch.where(t_is_n | (qc == N_VALUE), -N_PENALTY, s)

                temp = htl + s
                h_new = torch.maximum(torch.maximum(temp, f_in), e_in)
                tg = temp - goe
                if emit_flags:
                    # source-side nibble (kernel.py:641-673): H prefers
                    # temp, then E (strict >); gap opens win ties (>=);
                    # open bits only where the cell is computed
                    src = torch.where(
                        f_in > torch.maximum(temp, e_in), 2,
                        (e_in > temp).to(i32))
                    nib = (src
                           | ((C & (tg >= e_in - ge)).to(i32) << 2)
                           | ((C & (tg >= f_in - ge)).to(i32) << 3))
                    acc |= nib << (4 * k)
                    if return_mask:
                        cm |= (C.to(i32) * 15) << (4 * k)
                fst = torch.where(C, torch.maximum(tg, f_in - ge), f_in)
                e_nx = torch.where(C, torch.maximum(tg, e_in - ge), e_in)
                hf1, hf2 = torch.where(C, h_new, hf1), hf1
                est = torch.roll(e_nx, 1, 1)

                # first-wins (H << 16) + r maximum, wrapped like int32
                packed = (h_new.to(torch.int64) << 16) + r
                packed = ((packed + 2**31) & 0xFFFFFFFF) - 2**31
                packed = torch.where(C, packed, INT32_MIN)
                dmax = packed.max(dim=1, keepdim=True).values.to(i32)

                # per-pair bookkeeping (agatha_kernel.h:291-313, 336-356)
                live = (term == 0) & (d < end_p)
                gate = live & (((d < i_end8) & (d < n_diags)) | (d >= i_end8))
                th = dmax >> 16
                tr = dmax & 0xFFFF
                dq = d - tr
                upd = gate & (th > ms)
                if z >= 0:
                    zel = gate & ~(th > ms) & (tr >= mr) & (dq >= mq)
                    gap = ((tr - mr) - (dq - mq)).abs()
                    term = torch.where(
                        zel & (ms - th > z + gap * ge), 1, term
                    )
                ms = torch.where(upd, th, ms)
                mr = torch.where(upd, tr, mr)
                mq = torch.where(upd, dq, mq)
                diags = diags + live.to(i32)
            if emit_flags and D < planes:
                flags[:, D * W:(D + 1) * W] = acc
                if return_mask:
                    cmask[:, D * W:(D + 1) * W] = cm
            d8 += 8
    return result(torch.cat([ms, mq, mr, diags], dim=1))


# --- the CUDA kernel: signatures, launch ----------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _nvcc.Library("antidiag.cu", {
    "agatha_antidiag": ([_vp] * 4 + [_ci] * 13 + [_vp, _ci, _ci, _vp], _ci),
    "agatha_antidiag_occupancy": ([_ci] * 5, _ci),
})


def _check_wire(meta, tcodes, qfwd, *, gb_unit: int = B_PAIRS):
    """The bucket wire: (GB, 2) int32 meta and (GB, X) uint8 nibbles,
    GB a multiple of gb_unit (1: any GB)."""
    if meta.dim() != 2 or meta.shape[1] != 2 or meta.dtype != torch.int32:
        raise ValueError(f"meta must be (GB, 2) int32, got "
                         f"{tuple(meta.shape)} {meta.dtype}")
    gb = meta.shape[0]
    for name, x in (("tcodes", tcodes), ("qfwd", qfwd)):
        if x.dim() != 2 or x.shape[0] != gb:
            raise ValueError(f"{name} must be (GB, X) with GB={gb}, "
                             f"got {tuple(x.shape)}")
        if x.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 nibbles, got {x.dtype}")
    if gb % gb_unit:
        raise ValueError(f"GB={gb} is not a multiple of {gb_unit}")


def _align_bucket_cuda(meta, tcodes, qfwd, cfg, force_strips, planes):
    """Launch the kernel; planes > 0 selects the flag-emitting instance
    and returns (out, flags), flags defined on the computed cells of
    each pair's swept planes and uninitialised elsewhere."""
    _nvcc.check(("meta", meta), ("tcodes", tcodes), ("qfwd", qfwd))
    wt, qf, w_state, windowed, safe16 = _bucket_geometry(
        tcodes, qfwd, cfg, force_strips
    )
    if tile_threads(cfg, wt) > MAX_THREADS:
        raise ValueError(f"band_width {cfg.band_width} needs more than "
                         f"{MAX_THREADS} tile rows at W={wt}: the kernel "
                         "holds one tile row per thread")
    gb = meta.shape[0]
    out = torch.empty((gb, 4), dtype=torch.int32, device=meta.device)
    flags = None
    if planes:
        flags = torch.empty((gb, planes * w_state), dtype=torch.int32,
                            device=meta.device)
    if gb == 0:
        return (out, flags) if planes else out
    dev = LIB.launch(
        "agatha_antidiag", "antidiag.flags" if planes else "antidiag.score",
        meta.data_ptr(), tcodes.data_ptr(), qfwd.data_ptr(), out.data_ptr(),
        gb, wt, qf, w_state, int(windowed), int(safe16),
        cfg.match, cfg.mismatch, cfg.gap_oe, cfg.gap_extend,
        cfg.slice_width, cfg.z_threshold, cfg.band_width,
        flags.data_ptr() if planes else None, planes, on=meta,
    )
    if trace.on:
        emit = bool(planes)
        trace.count("fill.blocks", gb)
        trace.count("fill.slots", _nvcc.launch_slots(gb, _nvcc.resident(
            ("antidiag", wt, cfg.band_width, safe16, emit),
            lambda: occupancy(cfg, wt, safe16=safe16, emit_flags=emit,
                              device=dev), dev)))
    return (out, flags) if planes else out


def occupancy(cfg: AlignConfig, wt: int, *, safe16: bool,
              emit_flags: bool = False, device: int = 0) -> int:
    """Resident blocks per SM of the instance a bucket of width wt
    launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return _nvcc.blocks_per_sm(LIB.entry("agatha_antidiag_occupancy")(
        wt, cfg.band_width, int(safe16), int(emit_flags), device))


def align_bucket(
    meta: torch.Tensor,
    tcodes: torch.Tensor,
    qfwd: torch.Tensor,
    cfg: AlignConfig,
    *,
    force_strips: bool = False,
    emit_flags: bool = False,
    planes: int | None = None,
):
    """Align one shape-uniform bucket of pairs.

    Args:
      meta:   (GB, 2) int32 [qlen, rlen], GB % 8 == 0; padding pairs
              use qlen = rlen = 1.
      tcodes: (GB, W/2) uint8 nibble-packed target codes (low nibble
              first); W % 128 == 0 and W >= every padded target length.
      qfwd:   (GB, QF/2) uint8 nibble-packed query codes, left aligned;
              QF % 128 == 0 and QF > every padded query length.
      cfg:    alignment parameters.
      force_strips: keep the int16 strip round-trips even where the
              config is provably int16-safe (testing).
      emit_flags: also write the traceback flag bitmap (B3).
      planes: flag planes (default `flag_planes_needed(meta)`, which
              reads meta on the host: pass it to keep a CUDA call
              free of synchronisation).

    CUDA tensors launch the CUDA kernel asynchronously on the current
    stream; CPU tensors run `align_bucket_torch`.  Returns (GB, 4)
    int32 [score, query_end, target_end, diagonals_swept] on the input
    device; with ``emit_flags`` the pair (out, flags), flags (GB,
    planes * W_state) int32.
    """
    _check_wire(meta, tcodes, qfwd)
    if emit_flags and planes is None:
        planes = flag_planes_needed(meta.cpu().numpy(), cfg)
    if emit_flags and planes <= 0:
        raise ValueError(f"planes must be positive, got {planes}")
    if meta.device.type == "cuda":
        return _align_bucket_cuda(meta, tcodes, qfwd, cfg, force_strips,
                                  planes if emit_flags else 0)
    if meta.device.type != "cpu":
        raise ValueError(f"unsupported device {meta.device}")
    return align_bucket_torch(meta, tcodes, qfwd, cfg,
                              force_strips=force_strips,
                              emit_flags=emit_flags, planes=planes)
