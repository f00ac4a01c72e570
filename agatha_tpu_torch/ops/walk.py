"""Device traceback: the flag bitmap's walk into 2-bit move words.

PyTorch counterpart of `agatha_tpu.ops.walk`.  The flag-emitting
antidiagonal kernel (`ops.kernel.align_bucket(..., emit_flags=True)`)
writes one 4-bit nibble per DP cell; the walk starts each pair's cursor
at its best cell (t_end, q_end) and follows the nibbles back to the
origin, emitting one 2-bit move per step.  Only the move words leave
the device; the native decoder (`native.moves_to_cigars_batch`) turns
them into CIGARs on the host.

Nibble convention (source-side, written by the kernel at cell (r, c)):
  bits 0-1: this cell's H source (0 diag/temp, 1 E, 2 F)
  bit 2:    E(r+1, c) opened from temp(r, c)   (else extended)
  bit 3:    F(r, c+1) opened from temp(r, c)   (else extended)
The walk's E/F states sit on the source cell of the gap edge just
consumed.  Moves: 1 M (both), 2 D (target only), 3 I (query only).

Move words (the JAX package's convention): scan row i holds plane
P-1-i, the move made at base diagonal d = 8p + k in bits 2k of row
P-1-(d >> 3); row P holds the one boundary move at diagonal -1 (a path
that ends in a leading gap) in bits 0-1, as the JAX package's XLA walk
`_walk_jit` places it (its Pallas walk puts it in bits 14-15 of the same
row; the decoder reads both alike).  Two 16-bit rows pack per int32, low
half first, pair-major (GB, NW), NW padded with zero words to a
multiple of 128.

Two implementations of the walk:

* `walk_torch`: the plain version, a transcription of `_walk_jit`'s
  dense sweep (every plane from the top, eight substeps each) with one
  gather per substep in place of the TPU's one-hot reduce.
* `csrc/walk.cu`: the hand-written Hopper kernel, one warp per pair
  chasing its own path: the warp stages the flag words a round of 8
  planes can reach into shared memory a round ahead, and one lane walks
  them.

`walk` dispatches on the tensors' device, as `ops.kernel.align_bucket`
does.  `align_bucket_traceback` runs both kernels of one bucket.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from agatha_tpu_torch.config import AlignConfig
from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.ops.kernel import (
    GUARD,
    SHIFT_Q,
    align_bucket,
    flag_planes_needed,
    window_width,
)

_MOVE_CHAR = np.array(["", "M", "D", "I"])


def vbase_schedule(n_planes: int, cfg: AlignConfig, wt: int) -> np.ndarray:
    """Per-plane window origin (row of lane 0), as the kernel moves it.

    One half = 8 packed diagonals at a fixed vbase; the shift decision
    is pure in (d8, vbase), so the schedule is reproducible on the host.
    Buckets no wider than window_width have vbase == 0 everywhere.
    """
    out = np.zeros(n_planes, np.int32)
    W = window_width(cfg)
    if wt <= W:
        return out
    bw = cfg.band_width
    vb = 0
    for h in range(-(-n_planes // 8)):
        d8 = 64 * h
        want = (
            (((d8 - bw) >> 1) - GUARD) - vb >= SHIFT_Q
            and vb + SHIFT_Q <= wt - W
        )
        if want:
            vb += SHIFT_Q
        out[8 * h : 8 * h + 8] = vb
    return out


def words_per_pair(planes: int) -> int:
    """NW: planes + 1 scan rows, two per word, rounded up to 128."""
    return -(-(-(-(planes + 1) // 2)) // 128) * 128


def _check_walk(flags, vbases, ends):
    """(GB, planes, W) of a walk's inputs, or ValueError."""
    if flags.dim() != 2 or flags.dtype != torch.int32:
        raise ValueError(f"flags must be (GB, planes * W) int32, got "
                         f"{tuple(flags.shape)} {flags.dtype}")
    if vbases.dim() != 1 or vbases.dtype != torch.int32:
        raise ValueError(f"vbases must be (planes,) int32, got "
                         f"{tuple(vbases.shape)} {vbases.dtype}")
    gb, planes = flags.shape[0], vbases.shape[0]
    if planes == 0 or flags.shape[1] % planes:
        raise ValueError(f"flags width {flags.shape[1]} is not a multiple "
                         f"of the {planes} planes of vbases")
    if (ends.dim() != 2 or ends.shape != (gb, 4)
            or ends.dtype != torch.int32):
        raise ValueError(f"ends must be the ({gb}, 4) int32 kernel output, "
                         f"got {tuple(ends.shape)} {ends.dtype}")
    for name, x in (("vbases", vbases), ("ends", ends)):
        if x.device != flags.device:
            raise ValueError(f"{name} is on {x.device}, flags on "
                             f"{flags.device}")
    return gb, planes, flags.shape[1] // planes


def walk_torch(flags: torch.Tensor, vbases: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the walk (any device).

    flags (GB, planes * W) int32, vbases (planes,) int32, ends the
    (GB, 4) int32 kernel output [score, q_end, t_end, diags] -> move
    words (GB, NW) int32 on the input device.
    """
    gb, planes, W = _check_walk(flags, vbases, ends)
    dev = flags.device
    i32 = torch.int32
    rows = torch.zeros((2 * words_per_pair(planes), gb), dtype=i32,
                       device=dev)
    if gb == 0:
        return rows.T.contiguous()
    plane_of = flags.view(gb, planes, W)
    vb_host = vbases.cpu().tolist()
    r = ends[:, 2].clone()
    c = ends[:, 1].clone()
    st = torch.zeros(gb, dtype=i32, device=dev)
    # planes above every cursor hold no move: start at the highest one
    top = min(planes - 1, int((r + c).max()) >> 3)
    for p in range(top, -1, -1):
        plane = plane_of[:, p]
        word = torch.zeros(gb, dtype=i32, device=dev)
        for k in range(7, -1, -1):
            active = (r + c) == 8 * p + k
            inb = active & (r >= 0) & (c >= 0)
            lane = r - vb_host[p]
            # rows outside the window read 0, as the one-hot gives
            read = inb & (lane >= 0) & (lane < W)
            fl = plane.gather(1, lane.clamp(0, W - 1)[:, None])[:, 0]
            nib = (torch.where(read, fl, 0) >> (4 * k)) & 15
            src = nib & 3
            h_st = inb & (st == 0)
            e_st = inb & (st == 1)
            f_st = inb & (st == 2)
            h_e = h_st & (src == 1)
            h_f = h_st & (src == 2)
            e_open = e_st & ((nib & 4) != 0)
            f_open = f_st & ((nib & 8) != 0)
            is_m = (h_st & (src == 0)) | e_open | f_open
            is_d = h_e | (e_st & ~e_open)
            is_i = h_f | (f_st & ~f_open)
            # past the origin row / column: the trailing boundary runs
            b_i = active & (r < 0) & (c >= 0)
            b_d = active & (c < 0) & (r >= 0)
            mv = torch.where(
                is_m, 1,
                torch.where(is_d | b_d, 2, torch.where(is_i | b_i, 3, 0)),
            ).to(i32)
            r = r - (is_m | is_d | b_d).to(i32)
            c = c - (is_m | is_i | b_i).to(i32)
            st = torch.where(h_e, 1,
                             torch.where(h_f, 2, torch.where(is_m, 0, st)))
            word |= mv << (2 * k)
        rows[planes - 1 - p] = word
    # the boundary-only step at diagonal -1 (bits 0-1 of row `planes`)
    at = (r + c) == -1
    rows[planes] = torch.where(
        at & (c < 0) & (r >= 0), 2, torch.where(at & (r < 0) & (c >= 0), 3, 0)
    ).to(i32)
    return (rows[0::2] | (rows[1::2] << 16)).T.contiguous()


# --- the CUDA kernel: signatures, launch ----------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = _nvcc.Library("walk.cu", {
    "agatha_walk": ([_vp] * 4 + [_ci] * 5 + [_vp], _ci),
})


def _walk_cuda(flags, vbases, ends):
    gb, planes, W = _check_walk(flags, vbases, ends)
    _nvcc.check(("flags", flags), ("vbases", vbases), ("ends", ends))
    nw = words_per_pair(planes)
    words = torch.empty((gb, nw), dtype=torch.int32, device=flags.device)
    if gb == 0:
        return words
    LIB.launch(
        "agatha_walk", "walk",
        flags.data_ptr(), vbases.data_ptr(), ends.data_ptr(),
        words.data_ptr(), gb, planes, W, nw, on=flags,
    )
    return words


def walk(flags: torch.Tensor, vbases: torch.Tensor,
         ends: torch.Tensor) -> torch.Tensor:
    """Move words (GB, NW) int32 of a bucket's flag bitmap.

    CUDA tensors launch the CUDA kernel asynchronously on the current
    stream; CPU tensors run `walk_torch`.
    """
    if flags.device.type == "cuda":
        return _walk_cuda(flags, vbases, ends)
    if flags.device.type != "cpu":
        raise ValueError(f"unsupported device {flags.device}")
    return walk_torch(flags, vbases, ends)


def align_bucket_traceback(
    meta: torch.Tensor,
    tcodes: torch.Tensor,
    qfwd: torch.Tensor,
    cfg: AlignConfig,
    *,
    force_strips: bool = False,
    planes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Align one bucket and walk its flags, on the input device.

    Same inputs as `ops.kernel.align_bucket`.  Returns (out, words):
    the (GB, 4) int32 result and the (GB, NW) int32 move words.  On a
    CUDA device both kernels are queued on the current stream with no
    host synchronisation when ``planes`` is given (the engine passes
    `flag_planes_needed` of the host meta).  The flag bitmap's last
    reference dies here, so the caching allocator hands its memory to
    the next bucket once the walk is queued.
    """
    if planes is None:
        planes = flag_planes_needed(meta.cpu().numpy(), cfg)
    out, flags = align_bucket(meta, tcodes, qfwd, cfg,
                              force_strips=force_strips,
                              emit_flags=True, planes=planes)
    vbases = torch.from_numpy(
        vbase_schedule(planes, cfg, 2 * tcodes.shape[1]))
    if meta.device.type == "cuda":
        vbases = vbases.pin_memory().to(meta.device, non_blocking=True)
    return out, walk(flags, vbases, out)


def decode_moves(words: np.ndarray) -> np.ndarray:
    """Pair-major move words (GB, NW) -> (GB, NW * 16) uint8 moves in
    path order (alignment end -> start; 0 entries are inactive)."""
    words = np.asarray(words).T
    half, gb = words.shape
    w = np.empty((half * 2, gb), np.int32)
    w[0::2] = words & 0xFFFF
    w[1::2] = (words >> 16) & 0xFFFF
    ks = np.arange(7, -1, -1, dtype=np.int32)
    m = (w[:, None, :] >> (2 * ks)[None, :, None]) & 3
    return m.reshape(half * 2 * 8, gb).T.astype(np.uint8)


def moves_to_cigar(moves_row: np.ndarray) -> str:
    """One pair's move stream (end -> start, 0 = none) -> CIGAR string."""
    ops = moves_row[moves_row != 0][::-1]
    if ops.size == 0:
        return ""
    change = np.flatnonzero(np.diff(ops))
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change, [ops.size - 1]))
    counts = ends - starts + 1
    chars = _MOVE_CHAR[ops[starts]]
    return "".join(f"{n}{ch}" for n, ch in zip(counts, chars))
