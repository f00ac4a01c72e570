"""Column-sweep alignment of short-read buckets: gate, shapes, kernels.

PyTorch counterpart of `agatha_tpu.ops.colsweep` (the Pallas kernels
`_make_sweep_kernel` and `_make_chain_kernel` behind `_colsweep_jit`).
Where the band covers every diagonal of every pair and no DP value can
leave int16 range (`colsweep_eligible`), the slice / chunk / band
clipping and the int16 strip round-trips are vacuous, and the DP can be
swept one query column at a time:

1. **sweep** (B4): column j updates every target row at once.  E flows
   down the column as a prefix maximum, F and the diagonal-H input are
   carried from column to column.  Row r of column j sends the packed
   value (H << 16) + r to diagonal r + j of a ring of per-diagonal
   maxima, (d_pad, GB) int32, unreached entries INT32_MIN.
2. **chain** (B5): the reference's per-diagonal best / Z-drop schedule
   replayed over the ring in diagonal order, giving (GB, 4) int32
   [score, query_end, target_end, diagonals_swept], bit-identical to
   `align_one_sweep` and to the antidiagonal kernel on the same bucket.

Fake rows [rlen, 8 * ceil(rlen / 8)) are computed and pollute the
diagonal maxima exactly as in the reference; columns at or past qlen
and rows at or past 8 * ceil(rlen / 8) change nothing.

Two implementations of each step:

* `colsweep_sweep_torch`, `colsweep_chain_torch`: the plain versions
  over (GB, .) tensors; the CPU path and the card-side reference.
* `csrc/colsweep.cu` kernels `sweep` and `chain`: hand-written for
  Hopper, built with nvcc at first use and bound with ctypes.  The
  sweep has register instances (K = 4, 8, ..., 32 rows a lane, chosen
  by `sweep_rows`) and a shared-memory instance for bands past 1024
  rows; both write the ring pair-major, (GB, d_pad), and the wrapper
  returns its transposed view.

`align_bucket_colsweep` dispatches on the tensors' device: CPU tensors
take the plain pair, CUDA tensors launch both kernels on the current
stream (or the call raises).  Both return the ring as (d_pad, GB), so
the kernels are held against the plain versions ring for ring.
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
from agatha_tpu_torch.ops.kernel import _check_wire, _widen, int16_safe

_I64 = np.int64
# E-scan fill: loses every max and cannot wrap around.
_NEG_BIG = -(1 << 28)


def colsweep_eligible(meta: np.ndarray, cfg: AlignConfig,
                      safe16: bool) -> bool:
    """True when the column-sweep reformulation is exact for a bucket.

    meta is the (GB, 2) [qlen, rlen] array (padding rows qlen=rlen=1
    are harmless).  Tight condition (agatha_tpu/ops/colsweep.py's
    module docstring derives it): ``band >= max(qlen-1, 8*ceil(rlen/8)-1)``
    per pair, plus the int16-safe regime.
    """
    if not safe16:
        return False
    qlen = np.asarray(meta[:, 0], _I64)
    rlen = np.asarray(meta[:, 1], _I64)
    r8 = 8 * (-(-rlen // 8))
    need = np.maximum(qlen - 1, r8 - 1)
    return bool((need <= cfg.band_width).all())


def bucket_eligible(meta: np.ndarray, w: int, qf: int,
                    cfg: AlignConfig) -> bool:
    """Whether a bucket of target width w, query width qf takes colsweep.

    `colsweep_eligible` with the int16 bound taken over the bucket's
    wire widths, and the sweep kernel's state and ring fit in a block's
    shared memory (`sweep_fits`).  The second test is one the JAX
    package does not make: it fails only with gap_extend = 0 and bands
    past ~11k rows (with gap_extend >= 1 the int16 bound keeps eligible
    bands below ~7.7k rows), and such a bucket goes to the antidiagonal
    kernel, which gives the same results.
    """
    return (colsweep_eligible(meta, cfg, int16_safe(cfg, max_len=w + qf))
            and sweep_fits(_extents(meta, w, qf, cfg)))


def colsweep_shapes(meta, tcodes, qfwd, cfg: AlignConfig):
    """Static extents (R rows, Q cols, d_pad ring rows) of a bucket.

    As the JAX package rounds them: rows and columns up to a multiple
    of 32 (at most the wire widths), the ring up to a multiple of 128
    rows covering both R + Q and the last wrap-up diagonal.  tcodes and
    qfwd are the (GB, X/2) nibble wire (arrays or tensors).
    """
    return _extents(np.asarray(meta), 2 * tcodes.shape[1],
                    2 * qfwd.shape[1], cfg)


def _extents(meta: np.ndarray, cap_r: int, cap_q: int, cfg: AlignConfig):
    """`colsweep_shapes` for wire widths cap_r (target), cap_q (query)."""
    R = int(min(cap_r, -(-8 * int(-(-meta[:, 1].max() // 8)) // 32) * 32))
    Q = int(min(cap_q, -(-8 * int(-(-meta[:, 0].max() // 8)) // 32) * 32))
    sw = cfg.slice_width
    tad = -(-meta[:, 0].astype(_I64) // 8) + \
        -(-meta[:, 1].astype(_I64) // 8) - 1
    i_end8_max = int((-(-tad.max() // sw) * sw) * 8)
    d_pad = -(-max(i_end8_max + 8, R + Q) // 128) * 128
    return R, Q, d_pad


def _tr16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def colsweep_sweep_torch(meta, tcodes, qfwd, cfg: AlignConfig,
                         shapes) -> torch.Tensor:
    """Plain PyTorch version of the sweep kernel (any device).

    A transcription of the Pallas `_make_sweep_kernel` over (GB, R)
    int32 tensors: the same column loop, the log-step E prefix maximum,
    the chunk-start masks at columns j % 8 == 0.  Returns the ring
    (d_pad, GB) int32 on the input device.
    """
    R, Q, d_pad = shapes
    dev = meta.device
    i32 = torch.int32
    goe, ge, sw = cfg.gap_oe, cfg.gap_extend, cfg.slice_width
    gb = meta.shape[0]
    t = _widen(tcodes)[:, :R]
    q = _widen(qfwd)[:, :Q]
    qlen = meta[:, 0:1].to(i32)
    rlen = meta[:, 1:2].to(i32)
    r = torch.arange(R, dtype=i32, device=dev)[None, :]
    pr = r >> 3
    exist = r < (((rlen + 7) >> 3) << 3)
    fake = r >= rlen
    prev_fake = r >= rlen + 1
    ge_r = ge * r
    t_is_n = t == N_VALUE

    # left-strip inits (rows are inside the band by eligibility)
    k0 = _tr16(-(goe + ge * r))
    hprev = k0.expand(gb, R).clone()
    fst = _tr16(k0 - goe).expand(gb, R).clone()
    ring = torch.full((gb, d_pad), INT32_MIN, dtype=i32, device=dev)
    neg_big = torch.full((gb, R), _NEG_BIG, dtype=i32, device=dev)

    def shift_down(x, s, fill):
        return torch.cat([fill[:, :s], x[:, :-s]], dim=1)

    for j in range(Q):
        colm = qlen > j
        qb = q[:, j:j + 1]
        s = torch.where(qb == t, cfg.match, -cfg.mismatch)
        s = torch.where((qb == N_VALUE) | t_is_n, -N_PENALTY, s)
        top_h = 0 if j == 0 else int(_tr16(-(goe + ge * (j - 1))))
        top_e = int(_tr16(_tr16(-(goe + ge * j)) - goe))

        htl = torch.cat([torch.full((gb, 1), top_h, dtype=i32, device=dev),
                         hprev[:, :-1]], dim=1)
        f_in = fst
        if j % 8 == 0:
            # chunk-start mask for column j (pj = j // 8)
            g8 = j // 8
            cst = g8 == torch.clamp(((pr + g8) // sw) * sw - pr, min=0)
            htl = torch.where(cst & prev_fake, MINUS_INF2, htl)
            f_in = torch.where(cst & fake, MINUS_INF2, f_in)
        temp = htl + s

        # E prefix: e_in(r) = max(top_e - r*ge,
        #   max_{k<r} temp(k) - goe - (r-1-k)*ge)
        gv = temp - goe + ge_r
        p = torch.cat([torch.full((gb, 1), top_e - ge, dtype=i32,
                                  device=dev), gv[:, :-1]], dim=1)
        sft = 1
        while sft < R:
            p = torch.maximum(p, shift_down(p, sft, neg_big))
            sft *= 2
        e_in = p - (ge_r - ge)

        h_new = torch.maximum(torch.maximum(temp, f_in), e_in)
        f_new = torch.maximum(temp - goe, f_in - ge)
        fst = torch.where(colm, f_new, fst)
        hprev = torch.where(colm, h_new, hprev)

        # (H << 16) + r wrapped like int32
        packed = (h_new.to(torch.int64) << 16) + r
        packed = (((packed + 2**31) & 0xFFFFFFFF) - 2**31).to(i32)
        packed = torch.where(colm & exist, packed, INT32_MIN)
        seg = ring[:, j:j + R]
        ring[:, j:j + R] = torch.maximum(seg, packed)
    return ring.t().contiguous()


def _schedule(meta, sw: int):
    """Per-pair (i_end8, n_diags, end_p) of the Z-drop schedule."""
    qlen = meta[:, 0].to(torch.int32)
    rlen = meta[:, 1].to(torch.int32)
    tad = ((qlen + 7) >> 3) + ((rlen + 7) >> 3) - 1
    i_end8 = (torch.div(tad + (sw - 1), sw, rounding_mode="floor")
              * sw) << 3
    return i_end8, qlen + rlen - 1, i_end8 + 8


def colsweep_chain_torch(meta, ring, cfg: AlignConfig) -> torch.Tensor:
    """Plain PyTorch version of the chain kernel (any device).

    The Pallas `_make_chain_kernel` loop over the ring's diagonals with
    every pair at once.  Returns (GB, 4) int32 [score, query_end,
    target_end, diagonals_swept] on the input device.
    """
    return chain_replay_torch(ring, *_schedule(meta, cfg.slice_width), cfg)


def chain_replay_torch(ring, i_end8, n_diags, end_p,
                       cfg: AlignConfig) -> torch.Tensor:
    """The reference's per-diagonal best / Z-drop replay over a
    (D, GB) array of per-diagonal maxima, every pair at once, with the
    per-pair (GB,) gates i_end8, n_diags and end_p (the last diagonal
    swept + 1: the wrap-up's end, or the first empty slice's top).
    Returns (GB, 4) int32."""
    z, ge = cfg.z_threshold, cfg.gap_extend
    gb = ring.shape[1]
    zeros = torch.zeros(gb, dtype=torch.int32, device=ring.device)
    ms, mr, mq, term, diags = (zeros.clone() for _ in range(5))
    last = int(end_p.max()) if gb else 0
    for d in range(min(last, ring.shape[0])):
        dmax = ring[d]
        live = (term == 0) & (d < end_p)
        gate = live & (((d < i_end8) & (d < n_diags)) | (d >= i_end8))
        th = dmax >> 16
        tr = dmax & 0xFFFF
        dq = d - tr
        upd = gate & (th > ms)
        if z >= 0:
            zel = gate & ~(th > ms) & (tr >= mr) & (dq >= mq)
            gap = ((tr - mr) - (dq - mq)).abs()
            term = torch.where(zel & (ms - th > z + gap * ge), 1, term)
        ms = torch.where(upd, th, ms)
        mr = torch.where(upd, tr, mr)
        mq = torch.where(upd, dq, mq)
        diags = diags + live.to(torch.int32)
    return torch.stack([ms, mq, mr, diags], dim=1)


# --- the CUDA kernels: signatures, launch ---------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _nvcc.Library("colsweep.cu", {
    "agatha_colsweep_sweep": ([_vp] * 4 + [_ci] * 14 + [_vp], _ci),
    "agatha_colsweep_chain": ([_vp, _vp, _vp] + [_ci] * 6 + [_vp], _ci),
    "agatha_colsweep_occupancy": ([_ci] * 7, _ci),
})
# Shared memory one block may use on sm_90 (232,448 bytes).
SMEM_LIMIT = 232448
# Pairs (warps) per block of the sweep kernel, where they fit.
_MAX_WARPS_PER_BLOCK = 4
# Pairs (warps) per block of the chain kernel (csrc kChainWarps).
_CHAIN_WARPS = 4
# Rows a lane of the sweep's register instances (csrc/colsweep.cu
# sweep_regs_kernel<K>); a bucket whose R needs more takes the
# shared-memory instance.
SWEEP_REG_ROWS = tuple(range(4, 33, 4))


def sweep_rows(R: int) -> int:
    """Rows a lane K of the sweep instance a bucket of R rows takes:
    ceil(R / 32) rounded up to a multiple of 4 (at least 4; an odd lane
    stride K - 1 keeps the lanes' ring merges on distinct banks), or 0,
    the shared-memory instance, where that passes 32."""
    k = max(4, -(-R // 128) * 4)
    return k if k <= SWEEP_REG_ROWS[-1] else 0


def sweep_smem_bytes(R: int, d_pad: int) -> int:
    """Shared memory of one pair in the sweep's shared-memory instance:
    H, F and target codes over R rows rounded up to 32, and the d_pad-int
    ring.  The register instances need less (the ring and the query)."""
    return 4 * (3 * max(32, -(-R // 32) * 32) + d_pad)


def _sweep_regs_bytes(Q: int, d_pad: int) -> int:
    """Shared memory of one pair in a register instance: a spare int, the
    ring, and the Q query codes as bytes with 32 bytes of slack on either
    side, rounded up to 16."""
    return 4 * (1 + d_pad) + -(-(Q + 64) // 16) * 16


def sweep_launch(shapes) -> tuple[int, int]:
    """(rows a lane K, pairs a block) of the sweep launch for these
    (R, Q, d_pad): K from `sweep_rows` (0: the shared-memory instance),
    up to 4 pairs a block, as many as fit in its shared memory."""
    R, Q, d_pad = shapes
    k_rows = sweep_rows(R)
    per_pair = (_sweep_regs_bytes(Q, d_pad) if k_rows
                else sweep_smem_bytes(R, d_pad))
    return k_rows, min(_MAX_WARPS_PER_BLOCK, SMEM_LIMIT // per_pair)


def sweep_fits(shapes) -> bool:
    """Whether one pair of these (R, Q, d_pad) fits in a block."""
    R, _Q, d_pad = shapes
    return sweep_smem_bytes(R, d_pad) <= SMEM_LIMIT


def occupancy(shapes=None, *, chain: bool = False, device: int = 0) -> int:
    """Resident blocks per SM of the sweep launch for these (R, Q, d_pad)
    (the instance, pairs a block and shared memory of `sweep_launch`),
    or with ``chain`` of the chain launch, which takes no shapes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    if chain:
        args = (0, 0, 0, 1, 0)
    else:
        k_rows, wpb = sweep_launch(shapes)
        args = (*shapes, wpb, k_rows)
    return _nvcc.blocks_per_sm(LIB.entry("agatha_colsweep_occupancy")(
        int(chain), *args, device))


def _check_shapes(tcodes, qfwd, shapes):
    """`shapes` must lie within the wire and cover every diagonal that
    R rows and Q columns reach (no device data is read)."""
    R, Q, d_pad = shapes
    if not (0 <= R <= 2 * tcodes.shape[1] and 0 <= Q <= 2 * qfwd.shape[1]
            and d_pad >= R + Q - 1):
        raise ValueError(
            f"shapes (R, Q, d_pad)={tuple(shapes)} do not fit the wire "
            f"W={2 * tcodes.shape[1]} QF={2 * qfwd.shape[1]}")


def colsweep_sweep_cuda(meta, tcodes, qfwd, cfg: AlignConfig,
                        shapes) -> torch.Tensor:
    """Launch the sweep kernel; returns the ring (d_pad, GB) int32.

    `shapes` is `colsweep_shapes` of this bucket.  Rows past R and
    columns past Q are not swept, as in the plain version.  The kernel
    writes the ring pair-major, (GB, d_pad); the result is its
    transposed view, which `colsweep_chain_cuda` reads without a copy.
    Raises ValueError where one pair's state and ring do not fit in a
    block's shared memory (`sweep_fits`).
    """
    _check_wire(meta, tcodes, qfwd, gb_unit=1)
    _check_shapes(tcodes, qfwd, shapes)
    _nvcc.check(("meta", meta), ("tcodes", tcodes), ("qfwd", qfwd))
    R, Q, d_pad = shapes
    per_pair = sweep_smem_bytes(R, d_pad)
    if per_pair > SMEM_LIMIT:
        raise ValueError(f"sweep state and ring of {per_pair} bytes per "
                         f"pair exceed {SMEM_LIMIT} bytes of shared memory")
    gb = meta.shape[0]
    ring = torch.empty((gb, d_pad), dtype=torch.int32, device=meta.device)
    if gb == 0:
        return ring.t()
    k_rows, wpb = sweep_launch(shapes)
    dev = LIB.launch(
        "agatha_colsweep_sweep",
        "colsweep.sweep.regs" if k_rows else "colsweep.sweep.smem",
        meta.data_ptr(), tcodes.data_ptr(), qfwd.data_ptr(),
        ring.data_ptr(), gb, 2 * tcodes.shape[1], 2 * qfwd.shape[1],
        R, Q, d_pad, wpb, k_rows,
        cfg.match, cfg.mismatch, cfg.gap_oe, cfg.gap_extend,
        cfg.slice_width, on=meta,
    )
    if trace.on:
        blocks = -(-gb // wpb)
        trace.count("colsweep.buckets", 1)
        trace.count("colsweep.smem", k_rows == 0)
        trace.count("fill.sweep.blocks", blocks)
        trace.count("fill.sweep.slots", _nvcc.launch_slots(
            blocks, _nvcc.resident(
                ("colsweep.sweep", tuple(shapes)),
                lambda: occupancy(shapes, device=dev), dev)))
    return ring.t()


def colsweep_chain_cuda(meta, ring, cfg: AlignConfig) -> torch.Tensor:
    """Launch the chain kernel; returns (GB, 4) int32.

    `ring` is (d_pad, GB) int32: the kernel reads it pair-major, so the
    view `colsweep_sweep_cuda` returns is taken as it is, and a ring in
    the plain version's contiguous layout is copied pair-major first.
    """
    _nvcc.check(("meta", meta))
    gb = meta.shape[0]
    if (ring.dim() != 2 or ring.shape[1] != gb or ring.dtype != torch.int32
            or ring.device != meta.device):
        raise ValueError(f"ring must be (d_pad, {gb}) int32 on "
                         f"{meta.device}, got {tuple(ring.shape)} "
                         f"{ring.dtype} on {ring.device}")
    out = torch.empty((gb, 4), dtype=torch.int32, device=meta.device)
    if gb == 0:
        return out
    pair_major = ring.t().contiguous()  # a no-op on the sweep's view
    dev = LIB.launch(
        "agatha_colsweep_chain", "colsweep.chain",
        meta.data_ptr(), pair_major.data_ptr(), out.data_ptr(),
        gb, ring.shape[0], cfg.slice_width, cfg.z_threshold,
        cfg.gap_extend, on=meta,
    )
    if trace.on:
        blocks = -(-gb // _CHAIN_WARPS)
        trace.count("fill.chain.blocks", blocks)
        trace.count("fill.chain.slots", _nvcc.launch_slots(
            blocks, _nvcc.resident(
                ("colsweep.chain",),
                lambda: occupancy(chain=True, device=dev), dev)))
    return out


def align_bucket_colsweep(meta, tcodes, qfwd, cfg: AlignConfig, *,
                          shapes=None) -> torch.Tensor:
    """Column-sweep alignment of one bucket (align_bucket's contract).

    Args:
      meta, tcodes, qfwd: the bucket wire as for `ops.kernel.align_bucket`
        ((GB, 2) int32, (GB, W/2) and (GB, QF/2) uint8 nibbles); any GB.
      cfg: alignment parameters.  The caller has checked
        `colsweep_eligible` for the bucket.
      shapes: (R, Q, d_pad) from `colsweep_shapes` on the host meta.
        Computed here when omitted, which copies a CUDA meta to the host
        and so synchronises; the engine passes them.

    CUDA tensors launch the sweep then the chain kernel on the current
    stream without synchronising; CPU tensors run the plain versions.
    Returns (GB, 4) int32 [score, query_end, target_end,
    diagonals_swept] on the input device, bit-identical to align_bucket.
    """
    _check_wire(meta, tcodes, qfwd, gb_unit=1)
    if shapes is None:
        shapes = colsweep_shapes(meta.cpu().numpy(), tcodes, qfwd, cfg)
    _check_shapes(tcodes, qfwd, shapes)
    if meta.device.type == "cuda":
        ring = colsweep_sweep_cuda(meta, tcodes, qfwd, cfg, shapes)
        return colsweep_chain_cuda(meta, ring, cfg)
    if meta.device.type != "cpu":
        raise ValueError(f"unsupported device {meta.device}")
    ring = colsweep_sweep_torch(meta, tcodes, qfwd, cfg, shapes)
    return colsweep_chain_torch(meta, ring, cfg)

