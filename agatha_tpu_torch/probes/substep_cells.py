"""Times the B1-substep probes P3 and P4 of one revision of the port on
one CUDA device.

    PYTHONPATH=<tree> python3 agatha_tpu_torch/probes/substep_cells.py

prints the card's name and power limit, then `run_variant`'s lines for
P3's five variants (the original's G 32 x 39 packed diagonals, its
uniform 150 bp meta) and for P4's four variants at G 16 x 2400 packed
diagonals (128 pairs) and over 150 packed diagonals, both on ragged
11-13 kb meta from a fixed seed, and one JSON line of each variant's
ms a launch and per-block ns per substep.

It uses only what every revision of the probes has (`VARIANTS`,
`run_variant`), so that it can time another revision's package in the
same call: run it by path with `PYTHONPATH=<other tree>` first on the
path, in turns (old, new, new, old).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from agatha_tpu_torch.bench import device_line
from agatha_tpu_torch.probes import skew_probe, wave_probe

P3_G, P3_DIAGS = 32, 312 // 8
P4_G, P4_DIAGS, P4_SHORT = 16, 2400, 150


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device")
    print(f"# device={device_line()}")
    print(f"# package {wave_probe.__file__}", flush=True)
    out = {"P3": {}, f"P4 {P4_DIAGS}": {}, f"P4 {P4_SHORT}": {}}
    for name, B, W, nw, per in wave_probe.VARIANTS:
        r = wave_probe.run_variant(name, B, W, nw, P3_G * per, P3_DIAGS)
        out["P3"][name] = {"ms": r["ms"], "block_ns": r["block_ns"]}
    rng = np.random.default_rng(13)
    meta = torch.from_numpy(rng.integers(
        11000, 13001, (P4_G * skew_probe.B, 2)).astype(np.int32)).cuda()
    for n_diags in (P4_DIAGS, P4_SHORT):
        for name, W, frame, masks in skew_probe.VARIANTS:
            r = skew_probe.run_variant(name, W, P4_G, n_diags, frame=frame,
                                       masks=masks, meta=meta)
            out[f"P4 {n_diags}"][name] = {"ms": r["ms"],
                                          "block_ns": r["block_ns"]}
    print(json.dumps({"substep_cells": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
