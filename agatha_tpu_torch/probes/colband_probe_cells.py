"""Times the banded column-sweep cost probe (P2) of one revision of the
port on one CUDA device.

    PYTHONPATH=<tree> python3 agatha_tpu_torch/probes/colband_probe_cells.py [--rows]

prints the card's name and power limit, then `run_variant`'s line for
the original's seven variants (8 blocks of 128 pairs, 2048 columns) and
for the full variant and its four ablations at B7's headline window (RW
1536, one block of 128 pairs: `colband_probe.ABLATIONS`), each set's
shares of its full variant, and one JSON line of ns per column by set
and variant.  With `--rows` (revisions with instances of R rows a
thread) it also times the full variant at RW 768 and 384 on every
instance that takes the window.

It uses only what every revision of the probe has (`VARIANTS`,
`run_variant`), so that it can time another revision's package in the
same call: run it by path with `PYTHONPATH=<other tree>` first on the
path, in turns (old, new, new, old).
"""

from __future__ import annotations

import json
import sys

import torch

from agatha_tpu_torch.bench import device_line
from agatha_tpu_torch.probes import colband_probe as cp

G, NCOLS = 8, 2048
# colband_probe.ABLATIONS, which older revisions lack
ABLATION_RW, ABLATION_G = 1536, 1


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    print(f"# device={device_line()}")
    print(f"# package {cp.__file__}", flush=True)
    sets = {
        "variants": (cp.VARIANTS, G),
        "ablations": (tuple((name, ABLATION_RW, sw)
                            for name, _rw, sw in cp.VARIANTS[:5]),
                      ABLATION_G),
    }
    out = {}
    for label, (variants, g) in sets.items():
        ns = {name: cp.run_variant(name, RW, g, NCOLS, rounds=3,
                                   **switches)[0]
              for name, RW, switches in variants}
        full = ns[variants[0][0]]
        print(f"  {label}, share of the full variant: " + ", ".join(
            f"{name} {v / full:.4f}" for name, v in ns.items()), flush=True)
        out[label] = ns
    if "--rows" in sys.argv[1:]:
        out["rows"] = {
            f"RW {RW} R={R}": cp.run_variant(f"RW {RW} R={R}", RW, G, NCOLS,
                                             rounds=3, rows=R)[0]
            for RW in (768, 384) for R in (2, 4, 8)
            if cp.probe_rows(RW, R) == R}
    print(json.dumps({"ns_per_col": out, "G": G, "ncols": NCOLS,
                      "ablation_G": ABLATION_G}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
