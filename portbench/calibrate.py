"""Readings that the check's limits are set from, for one cell, in one
process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... --seconds <s>

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds`` at the cell's own load, the check) and, on the same inputs,
the control: the reference put in the program's place and computed in
bfloat16. It prints one JSON line a seed with both sets of readings, then
one summary line: the lower reading of each number (the largest the
program gives) and the upper one (the smallest the control gives). The
benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

import run  # noqa: E402  (sets the cache directories and the paths)


def main(argv=None, device_kind: str = "cuda", root: str = run.ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from harness.spec import load_cell

    cell = load_cell(root, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    why = run.missing_cards(cell, device_kind)
    if why:
        print(why, file=sys.stderr)
        return 2
    results = run.run_cell(cell, seeds, args.seconds, False, device_kind, control=True)
    lower, upper = {}, {}
    for seed, r in zip(seeds, results):
        prog = {k: c["value"] for k, c in r["checks"].items()}
        ctrl = {k: c["value"] for k, c in r["control_checks"].items()}
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "correct": r["correct"], "reads": r["reads"],
                          "samples_per_s": r["samples"] / r["wall_s"], "program": prog, "control": ctrl}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds), "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
