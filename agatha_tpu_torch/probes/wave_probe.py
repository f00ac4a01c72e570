"""Wave-interleave probe (P3): do independent pairs interleaved in one
program hide the per-substep latency chain of the B1 substep?

PyTorch / CUDA counterpart of `scripts/wave_probe.py` (the Pallas probe
kernel `make_waves` behind `run_variant`).  n_waves independent copies
of the substep (lengths offset by +w per wave, so no wave's masks can be
shared with another's) run interleaved: for each of the 8 substeps of a
packed diagonal, every wave's substep in turn.  See `substep_probe` for
what a substep holds.

Two implementations:

* `wave_probe_torch`: the plain version (any device);
* `wave_probe_cuda`: the instances of `csrc/substep_probe.cu` for
  n_waves 1, 2 and 4, on the tile kernel's layout: one block per pair
  with one thread per 8-lane tile row (32 threads at W 256, one warp:
  no block barrier), an 8x8 tile of lanes x substeps in registers a
  step.  A thread owns tile row pr of every wave, so a step holds
  n_waves independent tiles: whether a second tile per thread hides
  the step's latency, as it would B2's.

On the card B sets only the grid: the original's (B, W) program is B
pairs, here B blocks, so a (64, 256) program at half the programs is
the same launch as (32, 256) (the "B-sweep control" measures run to
run noise here, where on the TPU it showed the shuffle latency flat in
B).  Waves change the block: n_waves x the work per barrier.

    python -m agatha_tpu_torch.probes.wave_probe [G] [DIAGS]

times the original's five variants on a CUDA device and prints its
lines (ms, ns per substep per wave = time / (programs x substeps x
waves), the implied 150 bp read rate) and ratio lines, then each
variant in the card's units: per-block ns per substep (the launch time
over one block's substeps, per round of resident blocks) and
GCUPS-equivalent (the C-true cells over the launch time), with the
card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from agatha_tpu_torch.probes import substep_probe as sp



def wave_probe_torch(meta, W: int, n_waves: int, n_diags: int, *,
                     return_state: bool = False):
    """Plain PyTorch version of `make_waves` (any device): meta (N, 2)
    int32 -> (N, 4) int32 [ms, mr, mq, diags] folded over the waves, and
    with ``return_state`` the final scratch (per wave hfa, hfb, fst,
    est, qwin, tb, then every wave's qfw, along lanes)."""
    out, state, _cells = sp.plain(meta, W, n_diags, n_waves=n_waves)
    return (out, state) if return_state else out


def wave_probe_cuda(meta, W: int, n_waves: int, n_diags: int, *,
                    return_state: bool = False):
    """Launch one CUDA instance on the current stream; the results of
    `wave_probe_torch`."""
    sp.check_args(meta, W, n_diags, n_waves, False, False)
    return sp.launch("probe.wave", meta, W, n_diags, n_waves=n_waves,
                     return_state=return_state)


def wave_probe(meta, W: int, n_waves: int, n_diags: int, **kw):
    """The probe on meta's device: the CUDA instance for CUDA tensors
    (or the call raises), the plain version for CPU tensors."""
    if meta.device.type == "cuda":
        return wave_probe_cuda(meta, W, n_waves, n_diags, **kw)
    return wave_probe_torch(meta, W, n_waves, n_diags, **kw)


VARIANTS = (
    # name, B, W, n_waves, programs per G: the original's five variants
    ("base (prod map)", 32, 256, 1, 4),
    ("B-sweep control", 64, 256, 1, 2),
    ("wave2", 32, 256, 2, 2),
    ("wave4", 32, 256, 4, 1),
    ("wave2 B=64", 64, 256, 2, 1),
)


def run_variant(name, B, W, n_waves, G, n_diags, *, meta=None, reps=8,
                rounds=3) -> dict:
    """Time one variant on the card (G programs of B pairs, meta filled
    with 150 as in the original unless given) and print the original's
    line and the card's units."""
    n = G * B
    if meta is None:
        meta = torch.full((n, 2), 150, dtype=torch.int32, device="cuda")
    ms = sp.time_ms(lambda: wave_probe_cuda(meta, W, n_waves, n_diags),
                    reps, rounds)
    best = ms / 1e3
    ns = best / (G * n_diags * 8 * n_waves) * 1e9
    rate = B * n_waves * G / (best * 312.0 / (n_diags * 8))
    print(f"{name:16s} B={B:3d} W={W:4d} waves={n_waves}: "
          f"{ms:7.1f} ms  {ns:6.1f} ns/substep/wave  "
          f"implied {rate / 1e3:6.1f} k reads/s", flush=True)
    return {"ns": ns, **sp.card_report(ms, meta, W, n_diags, 16,
                                        n_waves=n_waves)}


def run_all(G: int, n_diags: int, **kw) -> dict:
    """Time the original's five variants (its G) and print its ratio
    lines; returns each variant's `run_variant` result by name."""
    print(f"G={G} programs x {n_diags} packed diagonals "
          "(x8 substeps each)", flush=True)
    res = {name: run_variant(name, B, W, nw, G * per, n_diags, **kw)
           for name, B, W, nw, per in VARIANTS}
    base = res["base (prod map)"]["ns"]
    for name, key in (("ctrl(B=64)", "B-sweep control"), ("wave2", "wave2"),
                      ("wave4", "wave4"), ("wave2 B=64", "wave2 B=64")):
        v = res[key]["ns"]
        print(f"{name:12s}/base per-substep-wave ratio: {v / base:.3f} "
              f"({'WIN' if v < base else 'LOSS'} "
              f"{abs(1 - v / base) * 100:.1f}%)")
    return res


def main(argv: list[str] | None = None) -> int:
    from agatha_tpu_torch.bench import device_line

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    G = int(argv[0]) if len(argv) > 0 else 32
    n_diags = int(argv[1]) if len(argv) > 1 else 312 // 8
    print(f"# device={device_line()}")
    run_all(G, n_diags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
