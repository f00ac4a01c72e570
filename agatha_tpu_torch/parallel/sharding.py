"""Rows of a bucket split over a list of local devices.

The port's counterpart of agatha_tpu/parallel/sharding.py.  The JAX
module shards a bucket's rows over a 1-D ``pairs`` mesh with
`shard_map`; here the mesh is an ordered tuple of torch devices, and
each contiguous shard of rows (what ``P("pairs", None)`` gives device
k) is copied to its device and aligned there by `ops.kernel.align_bucket`,
so each shard takes the windowed / int16-safe instance it would take on
one device.  A device may appear more than once: each entry is one slot
of the split, and slots on one card run in turn on its current stream.
"""

from __future__ import annotations

import contextlib
from collections.abc import Sequence

import numpy as np
import torch

from agatha_tpu_torch.config import AlignConfig
from agatha_tpu_torch.ops.kernel import B_PAIRS, align_bucket


def make_pairs_mesh(devices: Sequence | None = None
                    ) -> tuple[torch.device, ...]:
    """The ordered slots: every local CUDA device, or the given ones.

    Entries may repeat.  A CUDA entry without an index gets the current
    device's, so that each slot names one card.
    """
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("no devices for the mesh")
    return tuple(mesh)


def on_device(device: torch.device):
    """Make a CUDA device current for the block; nothing for the CPU.

    The kernels' C entry points set the CUDA device they launch on and
    leave it set, so each slot's work runs in this scope: then the
    allocations, copies and events that name no device land on the
    slot's card.
    """
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def host_to_device(arrays, device) -> tuple[torch.Tensor, ...]:
    """Host arrays as tensors on `device`; for a CUDA device staged in
    pinned memory and copied on its current stream without blocking the
    host.

    The host copy into pinned memory is NumPy's, on the calling thread:
    `Tensor.pin_memory()` copies in a parallel region over torch's
    intra-op threads, which stalls whenever one of their cores is busy
    with another thread or process.
    """
    device = torch.device(device)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            np.copyto(pinned.numpy(), t.numpy())
            t = pinned.to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def stage_shards(
    meta: np.ndarray,
    tcodes: np.ndarray,
    qfwd: np.ndarray,
    mesh: Sequence[torch.device],
) -> list[tuple[torch.Tensor, ...]]:
    """Split a bucket's host arrays into len(mesh) contiguous row shards
    and copy each to its slot's device (on a CUDA device without
    blocking the host).

    GB must be divisible by len(mesh) * B_PAIRS (pad with dummy pairs,
    `pad_rows`).
    """
    n_dev = len(mesh)
    gb = int(tcodes.shape[0])
    assert gb % (n_dev * B_PAIRS) == 0, (
        f"bucket rows {gb} not divisible by {n_dev} devices x {B_PAIRS}"
    )
    rows = gb // n_dev
    shards = []
    for k, dev in enumerate(mesh):
        sl = slice(k * rows, (k + 1) * rows)
        with on_device(dev):
            shards.append(host_to_device((meta[sl], tcodes[sl], qfwd[sl]),
                                         dev))
    return shards


def align_shards(
    shards: Sequence[tuple[torch.Tensor, ...]],
    cfg: AlignConfig,
    mesh: Sequence[torch.device],
) -> list[torch.Tensor]:
    """Launch `ops.kernel.align_bucket` on each staged shard under its
    slot's device; the outputs in row order, on a CUDA device still
    being computed on that device's current stream."""
    outs = []
    for shard, dev in zip(shards, mesh, strict=True):
        with on_device(dev):
            outs.append(align_bucket(*shard, cfg))
    return outs


def align_bucket_sharded(
    meta: np.ndarray,
    tcodes: np.ndarray,
    qfwd: np.ndarray,
    cfg: AlignConfig,
    mesh: Sequence[torch.device],
) -> list[torch.Tensor]:
    """Shard one bucket's pairs over the mesh and align.

    ``meta``, ``tcodes`` and ``qfwd`` are the bucket's host arrays (the
    wire of `ops.kernel.align_bucket`).  GB must be divisible by
    len(mesh) * B_PAIRS (pad with dummy pairs, `pad_rows`).  Returns the
    len(mesh) shards' (GB / len(mesh), 4) int32 outputs in row order,
    each on its slot's device and, on a CUDA device, still being
    computed on that device's current stream.
    """
    return align_shards(stage_shards(meta, tcodes, qfwd, mesh), cfg, mesh)


def pad_rows(arr: np.ndarray, rows: int, fill=1) -> np.ndarray:
    """Pad array along axis 0 to `rows` rows.

    The default fill of 1 keeps padded meta rows on align_bucket's
    documented dummy-pair contract (qlen = rlen = 1); a fill of 1 in
    code arrays is a harmless base code.
    """
    if arr.shape[0] == rows:
        return arr
    pad = np.full((rows - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)
