"""The control of the index cells' comparison, at a cell's own size.

    python -m portbench.control --workload <cell> --seeds 1,2,3 --steps <n>

For each seed it draws the cell's keys and traffic as a run does (on the
card when there is one), lets the control (the reference with keys
compared in float32, ``check.control_answers``) answer the warm-up and
``--steps`` more steps in the program's place, and holds its answers to
the reference by the run's own comparison.  It prints a JSON line a seed
with the counts compared; a sound control reading is not correct.  The
benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, index_traffic, spec


def control_counts(cell, seed: int, steps: int, device) -> dict:
    """The comparison's counts for the control over the warm-up and
    ``steps`` steps of ``cell``'s traffic, drawn from ``seed``."""
    mix, conf = cell.traffic, cell.config
    n = int(mix.get("warmup_steps", 3)) + int(steps)
    keys, t = index_traffic.for_cell(conf, mix, seed, n, device)
    ref_steps = [t.ref_step(s) for s in range(n)]
    got = check.control_answers(keys, ref_steps)
    counts, _ = check.compare(keys, ref_steps, got)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    cell = spec.cell(spec.load(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        counts = control_counts(cell, seed, args.steps, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "steps": args.steps, "device": device,
                          "correct": check.correct(counts),
                          "counts": counts,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
