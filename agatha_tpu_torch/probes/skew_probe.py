"""Skewed-frame probe (P4): what the skewed frame and interval masks buy
in the B1 substep.

PyTorch / CUDA counterpart of `scripts/skew_probe.py` (the Pallas probe
kernels `make_current`, `make_skewed`, `make_current_ival` and
`make_skewed_ival` behind `run_variant`).  The four forms of one base
antidiagonal (see `substep_probe`):

* ``frame="current"``: lane = row, masks hoisted per packed diagonal,
  three neighbour exchanges per substep (qwin, the diagonal H, E);
* ``frame="skewed"``: lane = row - r_lo(d); every second substep the
  frame advances (tb, F and H move one lane, the masks are recomputed),
  the diagonal H is the thread's own value; two exchanges on even
  substeps (qwin, E), three on odd ones;
* ``masks="cell"``: C from the slice / chunk / band tests per cell;
* ``masks="interval"``: C as two lane-range tests against per-pair
  bounds computed once per packed diagonal.

Two implementations:

* `skew_probe_torch`: the plain version (any device);
* `skew_probe_cuda`: the instances of `csrc/substep_probe.cu` on the
  mapping of the antidiagonal kernel (B1/B2, `csrc/antidiag.cu`): one
  block per pair with one thread per 8-lane tile row (128 threads at W
  1024 current, 112 at 896 skewed, in 4 warps), an 8x8 tile of lanes x
  substeps in registers a step, one `__syncthreads` per packed
  diagonal, so `current`'s time per substep is read beside B2's per
  diagonal, and the frames' and masks' costs beside a B2 step's.

    python -m agatha_tpu_torch.probes.skew_probe [G] [DIAGS]

times the original's four variants on a CUDA device (G programs of 8
pairs, meta filled with 12000 as in the original) and prints its lines
(ms, ns per substep = time / (programs x substeps)) and ratio lines,
then each variant in the card's units: per-block ns per substep and
GCUPS-equivalent, with the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from agatha_tpu_torch.probes import substep_probe as sp

B = 8    # pairs per program of the original

FRAMES = ("current", "skewed")
MASKS = ("cell", "interval")


def _switches(frame: str, masks: str) -> dict:
    if frame not in FRAMES or masks not in MASKS:
        raise ValueError(f"frame must be one of {FRAMES} and masks one of "
                         f"{MASKS}, got {frame!r}, {masks!r}")
    return {"skewed": frame == "skewed", "ival": masks == "interval"}


def skew_probe_torch(meta, W: int, n_diags: int, *, frame: str = "current",
                     masks: str = "cell", return_state: bool = False):
    """Plain PyTorch version of the four factories (any device): meta
    (N, 2) int32 -> (N, 4) int32 [ms, mr, mq, diags], and with
    ``return_state`` the final scratch (hfa, hfb, fst, est, qwin, tb,
    qfw and, skewed, tfw, along lanes)."""
    out, state, _cells = sp.plain(meta, W, n_diags, **_switches(frame, masks))
    return (out, state) if return_state else out


def skew_probe_cuda(meta, W: int, n_diags: int, *, frame: str = "current",
                    masks: str = "cell", return_state: bool = False):
    """Launch one CUDA instance on the current stream; the results of
    `skew_probe_torch`."""
    sw = _switches(frame, masks)
    sp.check_args(meta, W, n_diags, 1, sw["skewed"], sw["ival"])
    return sp.launch("probe.skew", meta, W, n_diags,
                     return_state=return_state, **sw)


def skew_probe(meta, W: int, n_diags: int, **kw):
    """The probe on meta's device: the CUDA instance for CUDA tensors
    (or the call raises), the plain version for CPU tensors."""
    if meta.device.type == "cuda":
        return skew_probe_cuda(meta, W, n_diags, **kw)
    return skew_probe_torch(meta, W, n_diags, **kw)


VARIANTS = (
    # name, W, frame, masks: the original's four variants
    ("current", 1024, "current", "cell"),
    ("skewed", 896, "skewed", "cell"),
    ("cur_ival", 1024, "current", "interval"),
    ("skw_ival", 896, "skewed", "interval"),
)


def run_variant(name, W, G, n_diags, *, frame="current", masks="cell",
                meta=None, reps=8, rounds=3) -> dict:
    """Time one variant on the card (G programs of 8 pairs, meta filled
    with 12000 as in the original unless given) and print the original's
    line and the card's units."""
    n = G * B
    if meta is None:
        meta = torch.full((n, 2), 12000, dtype=torch.int32, device="cuda")
    ms = sp.time_ms(lambda: skew_probe_cuda(meta, W, n_diags, frame=frame,
                                            masks=masks), reps, rounds)
    ns = ms * 1e6 / (G * n_diags * 8)
    print(f"{name:10s} W={W:5d}: {ms:7.1f} ms  {ns:6.1f} ns/substep",
          flush=True)
    return {"ns": ns, **sp.card_report(ms, meta, W, n_diags, 10,
                                        **_switches(frame, masks))}


def run_all(G: int, n_diags: int, **kw) -> dict:
    """Time the original's four variants and print its ratio lines;
    returns each variant's `run_variant` result by name."""
    print(f"G={G} programs x {n_diags} packed diagonals", flush=True)
    res = {name: run_variant(name, W, G, n_diags, frame=frame, masks=masks,
                             **kw)
           for name, W, frame, masks in VARIANTS}
    cur = res["current"]["ns"]
    # the original's reading: the same in-band cells per substep in both
    # frames, so the frame changes only the cost of a substep
    for name in ("skewed", "cur_ival", "skw_ival"):
        v = res[name]["ns"]
        print(f"{name}/current per-substep ratio: {v / cur:.3f} "
              f"({'WIN' if v < cur else 'LOSS'} "
              f"{abs(1 - v / cur) * 100:.1f}%)")
    return res


def main(argv: list[str] | None = None) -> int:
    from agatha_tpu_torch.bench import device_line

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    G = int(argv[0]) if len(argv) > 0 else 16
    n_diags = int(argv[1]) if len(argv) > 1 else 2400
    print(f"# device={device_line()}")
    run_all(G, n_diags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
