"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m h100bench.control --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23 --seconds 1 [--out <file.json>]

In one process: the program's run of the cell at its own size on each of
``--seeds`` (its compared numbers are the lower readings), then the
control's (the configuration's plain reference in bfloat16 storage, put in
the program's place) on each of ``--control-seeds`` (the upper readings).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from h100bench import harness, spec, traffic


def control_step(cell: spec.Cell) -> traffic.Replaced:
    names = [c["output"] for c in cell.config["step"]]
    return traffic.Replaced(
        names, lambda x: cell.reference.control(x, cell.traffic))


def readings(cell: spec.Cell, seed: int, seconds: float,
             step=None) -> dict:
    result = harness.run_cell(cell, seed, seconds, False, "cuda",
                              time.perf_counter_ns(), step=step)
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed": seed, "correct": result["correct"],
            "steps": result["attempted"],
            **{k: v["value"] for k, v in result["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100bench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    program = [readings(cell, s, args.seconds) for s in seeds]
    control = [readings(cell, s, args.seconds, control_step(cell))
               for s in cseeds]
    summary = {}
    for name in cell.traffic["limits"]:
        lo = [r[name] for r in program]
        up = [r[name] for r in control]
        lower = None if None in lo else max(lo)
        upper = None if None in up else min(up)
        summary[name] = {"lower": lower, "upper": upper,
                         "limit": cell.traffic["limits"][name],
                         "program": lo, "control": up}
    out = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "program": program, "control": control, "summary": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    for name, s in summary.items():
        print(f"{cell.name} {name}: lower {s['lower']} (max of "
              f"{len(seeds)} program seeds), upper {s['upper']} (min of "
              f"{len(cseeds)} control seeds), limit {s['limit']}")
    print(json.dumps({"workload": cell.name, "summary": {
        k: {"lower": v["lower"], "upper": v["upper"]}
        for k, v in summary.items()},
        "control_correct": [r["correct"] for r in control],
        "program_correct": [r["correct"] for r in program]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
