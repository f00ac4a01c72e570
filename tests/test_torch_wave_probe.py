"""P3, the wave-interleave probe: the port's plain version against the
Pallas original `scripts/wave_probe.py:make_waves` in interpret mode.

The original has no state output, so a wrapper kernel runs the factory's
kernel and then copies every scratch ref into an extra output; the
comparison is exact (tolerance 0) on the (N, 4) outputs and the whole
final scratch, with ragged meta (a distinct qlen / rlen per row: with
uniform meta Z-drop fires on the first substep and the outputs are
nearly constant).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.probes import substep_probe, wave_probe

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def original(name: str):
    """The Pallas original scripts/<name>.py, imported as the scripts
    import each other (scripts/ on sys.path; nothing there changes)."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


orig = original("wave_probe")

B = 8
W = 256


def ragged_meta(seed, n, qlo=100, qhi=360, rlo=90, rhi=462):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(qlo, qhi, n), rng.integers(rlo, rhi, n)],
                    axis=1).astype(np.int32)


def pallas_with_state(kernel, scratch, meta, block_rows):
    """Run `kernel(meta_ref, out_ref, *scratch)` over row blocks in
    interpret mode; returns (out, the final scratch concatenated along
    lanes), both NumPy."""
    n = meta.shape[0]
    widths = [s.shape[1] for s in scratch]
    total = sum(widths)

    def wrapper(meta_ref, out_ref, state_ref, *scr):
        kernel(meta_ref, out_ref, *scr)
        off = 0
        for ref, w in zip(scr, widths):
            state_ref[:, off:off + w] = ref[:, :]
            off += w

    def spec(w):
        return pl.BlockSpec((block_rows, w), lambda g: (g, 0),
                            memory_space=pltpu.VMEM)

    out, state = pl.pallas_call(
        wrapper,
        grid=(n // block_rows,),
        in_specs=[spec(2)],
        out_specs=[spec(4), spec(total)],
        out_shape=[jax.ShapeDtypeStruct((n, 4), jnp.int32),
                   jax.ShapeDtypeStruct((n, total), jnp.int32)],
        scratch_shapes=scratch,
        interpret=True,
    )(meta)
    return np.asarray(out), np.asarray(state)


def run_original(meta, n_waves, n_diags):
    scratch = []
    for _ in range(n_waves):
        scratch += [pltpu.VMEM((B, W), jnp.int32) for _ in range(6)]
    scratch += [pltpu.VMEM((B, 3 * orig.LANE), jnp.int32)
                for _ in range(n_waves)]
    return pallas_with_state(orig.make_waves(B, W, n_waves, n_diags),
                             scratch, meta, B)


@pytest.mark.parametrize("n_waves, n_diags, seed", [
    (1, 6, 1), (2, 6, 2), (4, 6, 3), (2, 20, 4),
], ids=["1-wave", "2-waves", "4-waves", "2-waves-20-diags"])
def test_plain_version_equals_pallas_original(n_waves, n_diags, seed):
    """Outputs and final state (6 (B, W) arrays per wave, then each
    wave's feed) bit for bit; 20 packed diagonals wrap the kph slice
    schedule and pass d8 = 128, where the feed phase wraps."""
    meta = ragged_meta(seed, B)
    ref, ref_state = run_original(meta, n_waves, n_diags)
    out, state = wave_probe.wave_probe_torch(
        torch.from_numpy(meta), W, n_waves, n_diags, return_state=True)
    assert out.dtype == state.dtype == torch.int32
    assert state.shape == (B, substep_probe.state_width(W, n_waves, False))
    assert np.array_equal(out.numpy(), ref)
    assert np.array_equal(state.numpy(), ref_state)
    # the state is not trivially equal: it moved from its iota start
    assert len(np.unique(ref[:, 0])) > 1 or len(np.unique(ref_state)) > 100


def test_rows_are_independent_pairs():
    """G programs of B rows are one (G * B, W) problem: the plain version
    on 16 rows equals two runs of 8, and the original on a grid of two."""
    meta = ragged_meta(5, 2 * B)
    out = wave_probe.wave_probe_torch(torch.from_numpy(meta), W, 1, 4)
    halves = torch.cat([wave_probe.wave_probe_torch(
        torch.from_numpy(meta[i:i + B]), W, 1, 4) for i in (0, B)])
    assert torch.equal(out, halves)
    ref, _ = run_original(meta, 1, 4)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n_waves", [1, 4])
def test_cell_count_matches_the_plain_version(n_waves):
    """count_cells (8 substeps at once, no DP) == the C-true cells the
    plain version's loop counted."""
    meta = torch.from_numpy(ragged_meta(6, 4))
    _out, _state, cells = substep_probe.plain(meta, W, 20, n_waves=n_waves)
    assert cells > 0
    assert substep_probe.count_cells(meta, W, 20, n_waves=n_waves) == cells


def test_dispatch_and_cuda_wrapper_checks():
    meta = torch.from_numpy(ragged_meta(7, B))
    assert torch.equal(wave_probe.wave_probe(meta, W, 2, 3),
                       wave_probe.wave_probe_torch(meta, W, 2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wave_probe.wave_probe_cuda(meta, W, 2, 3)
    with pytest.raises(ValueError, match="int32"):
        wave_probe.wave_probe_cuda(meta.long(), W, 2, 3)
    with pytest.raises(ValueError, match="n_waves"):
        wave_probe.wave_probe_torch(meta, W, 3, 3)
    assert _nvcc.launches["probe.wave"] == 0


def test_main_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        wave_probe.main([])
