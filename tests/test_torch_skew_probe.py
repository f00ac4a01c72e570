"""P4, the skewed-frame probe: the port's plain version against the four
Pallas originals of `scripts/skew_probe.py` (`make_current`,
`make_skewed`, `make_current_ival`, `make_skewed_ival`) in interpret
mode, exactly (tolerance 0), on the (N, 4) outputs and the whole final
scratch, with ragged meta.  The state is read through a wrapper kernel
that copies every scratch ref into an extra output after the factory's
kernel (see tests/test_torch_wave_probe.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from agatha_tpu_torch.ops import _nvcc
from agatha_tpu_torch.probes import skew_probe, substep_probe

from .test_torch_wave_probe import original, pallas_with_state, ragged_meta

orig = original("skew_probe")

W = 256
FACTORIES = {
    ("current", "cell"): orig.make_current,
    ("skewed", "cell"): orig.make_skewed,
    ("current", "interval"): orig.make_current_ival,
    ("skewed", "interval"): orig.make_skewed_ival,
}


def run_original(meta, frame, masks, n_diags):
    scratch = [pltpu.VMEM((orig.B, W), jnp.int32) for _ in range(6)]
    scratch.append(pltpu.VMEM((orig.B, 3 * orig.LANE), jnp.int32))
    if frame == "skewed":
        scratch.append(pltpu.VMEM((orig.B, 3 * orig.LANE), jnp.int32))
    return pallas_with_state(FACTORIES[frame, masks](W, n_diags), scratch,
                             meta, orig.B)


@pytest.mark.parametrize("frame, masks, n_diags", [
    ("current", "cell", 6), ("skewed", "cell", 6),
    ("current", "interval", 6), ("skewed", "interval", 6),
    ("skewed", "cell", 20),
], ids=["current", "skewed", "cur_ival", "skw_ival", "skewed-20-diags"])
def test_plain_version_equals_pallas_original(frame, masks, n_diags):
    meta = ragged_meta(10 + n_diags, orig.B)
    ref, ref_state = run_original(meta, frame, masks, n_diags)
    out, state = skew_probe.skew_probe_torch(
        torch.from_numpy(meta), W, n_diags, frame=frame, masks=masks,
        return_state=True)
    assert state.shape == (orig.B, substep_probe.state_width(
        W, 1, frame == "skewed"))
    assert np.array_equal(out.numpy(), ref)
    assert np.array_equal(state.numpy(), ref_state)


@pytest.mark.parametrize("frame", ["current", "skewed"])
@pytest.mark.parametrize("masks", ["cell", "interval"])
def test_cell_count_matches_the_plain_version(frame, masks):
    meta = torch.from_numpy(ragged_meta(11, 4))
    sw = {"skewed": frame == "skewed", "ival": masks == "interval"}
    _out, _state, cells = substep_probe.plain(meta, W, 20, **sw)
    assert cells > 0
    assert substep_probe.count_cells(meta, W, 20, **sw) == cells


def test_current_frame_is_one_wave():
    """make_current is make_waves with one wave: the same function."""
    meta = torch.from_numpy(ragged_meta(12, orig.B))
    from agatha_tpu_torch.probes import wave_probe

    assert torch.equal(skew_probe.skew_probe_torch(meta, W, 7),
                       wave_probe.wave_probe_torch(meta, W, 1, 7))


def test_dispatch_and_cuda_wrapper_checks():
    meta = torch.from_numpy(ragged_meta(13, orig.B))
    assert torch.equal(
        skew_probe.skew_probe(meta, W, 3, frame="skewed"),
        skew_probe.skew_probe_torch(meta, W, 3, frame="skewed"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        skew_probe.skew_probe_cuda(meta, W, 3)
    with pytest.raises(ValueError, match="int32"):
        skew_probe.skew_probe_cuda(meta.long(), W, 3)
    with pytest.raises(ValueError, match="frame"):
        skew_probe.skew_probe_torch(meta, W, 3, frame="diagonal")
    assert _nvcc.launches["probe.skew"] == 0


def test_main_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        skew_probe.main([])
