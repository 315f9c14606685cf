"""Readings for the limits of ``correct``: the compared numbers of sound
runs of the port over many seeds, and of the control (the plain
reference in TF32, the precision below the configurations' fp32 with
TF32 off, in the port's place), each seed a full run of the cell at its
own size, all in one process:

    python3 portbench/calibrate.py --workload drawing.clips \\
        --seconds 5 --seeds 11 12 13 [--control]

One JSON line a seed: the numbers, the end-to-end metrics and correct.
``--fault <name>`` plants a fault of ``faults.py`` in the port instead."""
import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   help="plant this fault in the port's timed path")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[portbench] calibrate needs a CUDA device", file=sys.stderr)
        return 2
    harness.set_cache_dirs(ROOT)
    torch.set_num_threads(harness.HOST_THREADS)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            r = harness.run_cell(cell, seed, args.seconds, False,
                                 control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "correct": r["correct"],
                          "numbers": r["_numbers"],
                          "metrics": {k: m["value"] for k, m in
                                      r["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
