"""csrc/substep_probe.cu (the B1-substep probes P3 and P4) itself,
compiled with g++ against the stand-in for the CUDA built-ins of
tests/test_torch_antidiag_standin.py, against the plain version
`probes.substep_probe.plain` on the CPU.

The kernel's source is used as it is up to its C entry (the launch is
the stand-in's: one fiber per CUDA thread, the shuffles, `redux.sync`
and `__syncthreads` as barriers).  Every instance (1, 2 and 4 waves in
the current frame, the current frame with interval masks, the skewed
frame with cell or interval masks) is held to the plain version with
tolerance 0 on the (N, 4) outputs and the whole final state, at widths
of one tile-row warp or less (W 32, 64, 256: no block barrier) and of
several (W 896, 3.5 warps; W 1024, 4), over 0, 1, 6 and 20 packed
diagonals (20 passes the slice schedule's wraps and substep 128, where
the original's feed phase wraps), the widths of several warps over 72
as well (within 32 packed diagonals every C-true cell lies in the first
warp's lanes, so only then do the per-warp maxima meet).  The meta is
ragged, with row counts below and above W and below the substeps run,
so that fake rows and chunk starts fall inside tiles.  It checks the tiling, the hand-offs
within and across warps, the maxima and the state stores; not the
card's compiler, timing or memory model.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from agatha_tpu_torch.probes import substep_probe

from .test_torch_antidiag_standin import CSRC, compile_standin

torch.set_num_threads(1)

DRIVER = r"""
#include "cuda_runtime.h"
enum : int { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
#include "kernel_body.inc"
extern "C" int run(const void* meta, void* out, void* state, int n, int W,
                   int n_diags, int n_waves, int skewed, int ival) {
  cudaError_t err;
  const Kernel kern = prepare(W, n_waves, skewed, ival, err);
  if (kern == nullptr) return 1;
  for (int b = 0; b < n; ++b) {
    run_block(b, block_threads(W), [&] {
      kern(static_cast<const int32_t*>(meta), static_cast<int32_t*>(out),
           static_cast<int32_t*>(state), W, n_diags);
    });
  }
  return 0;
}
"""

# (W, n_waves, skewed, ival): every instance, each at the widths named
INSTANCES = [(W, nw, False, False) for W in (32, 64, 256)
             for nw in (1, 2, 4)] + [
    (1024, 1, False, False), (1024, 1, False, True),
    (896, 1, True, False), (896, 1, True, True)]
CASES = [(inst, n_diags) for inst in INSTANCES for n_diags in (0, 1, 6, 20)
         ] + [(inst, 72) for inst in INSTANCES if inst[0] > 256]


def _id(case):
    (W, nw, skewed, ival), n_diags = case
    frame = "skewed" if skewed else "current"
    return f"W{W}-{nw}w-{frame}-{'ival' if ival else 'cell'}-{n_diags}"


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    d = tmp_path_factory.mktemp("substep_standin")
    with open(os.path.join(CSRC, "substep_probe.cu")) as f:
        src = f.read()
    body = src[src.index('#include "antidiag_common.cuh"'):
               src.index("// Launches one instance")]
    common = os.path.join(CSRC, "antidiag_common.cuh")
    body = body.replace('#include "antidiag_common.cuh"',
                        f'#include "{common}"')
    lib = compile_standin(d, body, DRIVER)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [vp] * 3 + [ci] * 6
    lib.run.restype = ci
    return lib


def ragged_meta(W: int, seed: int, n: int = 6) -> np.ndarray:
    """(n, 2) int32 [qlen, rlen]: half the pairs short (rows end below
    the substeps run, so fake rows and chunk starts fall in tiles), half
    between W / 2 and 2 W."""
    rng = np.random.default_rng(seed)
    short = rng.integers(3, 120, (n // 2, 2))
    long = rng.integers(max(W // 2, 8), 2 * W, (n - n // 2, 2))
    return np.concatenate([short, long]).astype(np.int32)


def run_standin(lib, meta, W, n_diags, n_waves, skewed, ival):
    """The instance's (N, 4) outputs and final state on the CPU."""
    n = meta.shape[0]
    out = np.full((n, 4), -7, np.int32)
    state = np.full((n, substep_probe.state_width(W, n_waves, skewed)), -7,
                    np.int32)
    assert lib.run(meta.ctypes.data, out.ctypes.data, state.ctypes.data, n,
                   W, n_diags, n_waves, int(skewed), int(ival)) == 0
    return out, state


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_standin_equals_plain(standin, case):
    """Outputs and the whole final state bit for bit (state pre-filled
    with -7, so a lane the kernel does not store shows)."""
    (W, nw, skewed, ival), n_diags = case
    meta = ragged_meta(W, 100 + W + nw + 10 * n_diags)
    got, state = run_standin(standin, meta, W, n_diags, nw, skewed, ival)
    ref, ref_state, _cells = substep_probe.plain(
        torch.from_numpy(meta), W, n_diags, n_waves=nw, skewed=skewed,
        ival=ival)
    assert np.array_equal(got, ref.numpy()), (got, ref)
    bad = np.nonzero((state != ref_state.numpy()).any(axis=0))[0]
    assert bad.size == 0, bad[:8]


def test_standin_no_state_pointer(standin):
    """A launch without the state writes the same outputs."""
    W, n_diags = 1024, 6
    meta = ragged_meta(W, 7)
    ref, _state = run_standin(standin, meta, W, n_diags, 1, False, False)
    out = np.full((meta.shape[0], 4), -7, np.int32)
    assert standin.run(meta.ctypes.data, out.ctypes.data, None,
                       meta.shape[0], W, n_diags, 1, 0, 0) == 0
    assert np.array_equal(out, ref)


def test_standin_takes_what_the_wrapper_takes(standin):
    """The kernel's `prepare` admits exactly the widths and switches
    `substep_probe.check_args` accepts (n 0: nothing runs)."""
    meta = torch.zeros((0, 2), dtype=torch.int32)
    z = np.zeros(8, np.int32)
    for nw in (1, 2, 3, 4):
        for skewed, ival in ((0, 0), (0, 1), (1, 0), (1, 1)):
            for W in list(range(0, 1100, 8)) + [2048]:
                ok = standin.run(z.ctypes.data, z.ctypes.data, None, 0, W,
                                 4, nw, skewed, ival) == 0
                try:
                    substep_probe.check_args(meta, W, 4, nw, bool(skewed),
                                             bool(ival))
                    want = True
                except ValueError as e:
                    # the CPU tensor is refused last, after the widths
                    want = "CUDA tensors" in str(e)
                assert ok == want, (W, nw, skewed, ival)
