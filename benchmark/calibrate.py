"""The readings that a cell's limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... [--control-seeds 11 12 13] [--seconds 0]

For each seed, one run of the cell as the command makes it
(:func:`harness.run_cell`: set-up, a window of ``--seconds``, at least one
call, the reference and the comparison), and for each control seed also
the control's numbers: the reference put in the program's place and
computed one precision lower (float32 with TF32 matrix products), held to
the float64 reference. One JSON line a seed: every number's worst over the
run's calls, the control's, and the reference's and the control's seconds.
Runs on the card (``--device cpu`` for a rehearsal).
"""

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0, help="each run's window (0: one call)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import run_cell
    from benchmark.layout import Layout

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    lay = Layout()
    for seed in args.seeds:
        result, _, readings = run_cell(lay, args.workload, seed, args.seconds, False, device,
                                       control=seed in args.control_seeds)
        out = {"cell": args.workload, "seed": seed, "correct": result["correct"], "calls": result["attempted"],
               "program": readings.pop("worst"), **readings,
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
