"""The readings a cell's limits are set from: the check's numbers of the
program on many seeds, and of the control (the reference one precision
step below, in the program's place) on the first few, in one process.

    python3 benchmark/calibrate.py --workload int8-single \\
        --seeds 101,102,103 --control-seeds 3 --seconds 8 \\
        [--numbers audio_err]

Each seed is one whole run (``run.run_cell``: weights, warm-up, a short
window at the cell's own load, the check) whose line goes to standard
output and to ``chiprun_out/calibrate_<cell>.jsonl``; the limits the
cell holds are printed beside each number on standard error.
``--numbers`` reads only the named numbers (one stage's limit set anew
without paying for the others' reference).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also read the control")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--numbers", default="",
                    help="comma-separated check numbers to read (all)")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, run as R

    R._env()
    spec = harness.load_spec()
    cell = harness.cell(spec, args.workload)
    device = torch.device("cuda", 0)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"calibrate_{args.workload}.jsonl")
    seeds = [int(s) for s in args.seeds.split(",")]
    mix = harness.mix_of(cell)
    if args.numbers:
        names = args.numbers.split(",")
        mix["check"] = dict(mix["check"], numbers=names, limits={
            k: mix["check"]["limits"].get(k) for k in names})
    for i, seed in enumerate(seeds):
        out = R.run_cell(spec, cell, seed, args.seconds, False, device,
                         time.monotonic(), mix=mix,
                         control=i < args.control_seeds)
        line = {"seed": seed, "check": {k: v["value"]
                                        for k, v in out["check"].items()},
                "control": out.get("control"),
                "attempted": out["attempted"], "failed": out["failed"],
                "metrics": out["metrics"], "check_s": out["check_s"]}
        print(json.dumps(line), flush=True)
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
