"""The control of a cell's check, read on the card at the cell's size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed: the cell's pool from the seed, a sample as large as a
run draws (over as many batches of the pool as its candidates need),
and the reference at the
configuration's `control_bits` put in the program's place and judged by
`benchmark.check` as the program is.  The control has to come out as not
correct: one JSON line a seed with its numbers and the reference's time.
The benchmark's own runs never run this.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, generator, spec  # noqa: E402


def reading(cell: spec.Cell, seed: int, device: str) -> dict:
    cfg, tr = cell.config, cell.traffic
    pool = generator.make_pool(tr, int(cfg["pool_batches"]), seed, device)
    keeper = check.Keeper(pool, seed, int(tr["check_candidates"]))
    n = len(pool[0][0])
    per = max(1, min(n, int(tr["check_candidates"])))
    for k in range(-(-int(tr["check_pairs"]) // per) + 1):
        keeper.batches.append((k % len(pool), np.zeros((n, 4), np.int64),
                               {}))
    sample = check.draw_sample(keeper, seed, int(tr["check_pairs"]))
    t = time.perf_counter()
    got = check.control_reading(keeper, sample, cfg, device)
    return {"cell": cell.name, "seed": seed,
            "control_bits": cfg["control_bits"],
            "pairs_wrong": got["pairs_wrong"][0],
            "checked": got["checked"],
            "seconds_for_both": time.perf_counter() - t}


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    for seed in a.seeds:
        print(json.dumps(reading(cell, seed, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
