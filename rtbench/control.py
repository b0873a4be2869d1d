#!/usr/bin/env python3
"""The controls of ``correct``: readings that have to come out as not
correct, at a cell's own size, on the card.

    python3 rtbench/control.py --workload <cell> --seeds 1,2,3 \
        [--fault stale|half|alter | --program] [--seconds 2]

Without ``--fault`` the control is the reference put in the program's
place and computed in bfloat16, the nearest precision below the float32
that the configuration states (``render.dtype``), and judged by the same
comparison against the float32 reference (the loop module's
``control``): a fly cell's sampled pixels of frames drawn from the seed,
a fit cell's target, first image, losses, first gradients and change.
With ``--fault`` it runs the cell with the program's timed path broken
(the ``FAULTS`` of the cell's loop module) through a short window; with
``--program`` unbroken, for the readings of sound runs. One JSON line a
seed, with the numbers and the limits.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from rtbench import run  # noqa: E402

LOWER = torch.bfloat16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--program", action="store_true",
                    help="run the program unbroken instead: the readings "
                         "of sound runs, many seeds in one process")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = run.load_cell(args.workload, seed)
        if args.fault or args.program:
            out = run.run_cell(cell, args.seconds, False, device,
                               fault=args.fault)
            nums = out["numbers"]
        else:
            nums = run.load_kind(cell.mix["kind"]).control(cell, device,
                                                           LOWER)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": ("program" if args.program
                                      else args.fault or "bfloat16"),
                          "numbers": nums, "limits": cell.limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
