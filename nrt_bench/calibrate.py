"""Readings from which the limits of the output check are set: in one
process, the numbers a cell compares for sound runs of the program on many
seeds, for its lower-precision control (the program's own bfloat16 path),
and for planted faults, each at the cell's own size.

    python3 -m nrt_bench.calibrate --workload flagship.train --seeds 12 \\
        --control-seeds 3 --faults half_batch --seconds 2 --mix '{"block_steps": 3}'

Each reading is one JSON line on standard output: the variant, the seed and
the numbers.  A short window suffices: a training cell's numbers come from
set-up's recorded steps, a render cell's from the views its window
completed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="", help="comma-separated planted faults")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    ap.add_argument("--mix", default="{}",
                    help="JSON of mix parameters to change, such as a shorter block of steps")
    args = ap.parse_args(argv)
    mix = json.loads(args.mix)
    plan = [(None, args.seeds), ("bf16", args.control_seeds)]
    plan += [(f, args.fault_seeds) for f in args.faults.split(",") if f]
    for variant, n in plan:
        for k in range(n):
            seed = args.first_seed + 7919 * k
            t = time.perf_counter()
            r = run_cell(args.workload, seed, args.seconds, False, variant=variant, start=t,
                        mix_changes=mix, all_numbers=True)
            print(json.dumps({"variant": variant or "program", "seed": seed,
                              "numbers": r["numbers"],
                              "attempted": r["attempted"],
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
