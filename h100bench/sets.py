"""Run one cell several times, each run its own process, and report the
spread of each metric: what the bounds in ``BENCHMARK.json`` are set from.

    python3 -m h100bench.sets --workload <cell> --seconds 10 \
        --sets 11,12,13,14,15,16 --repeat 2 [--traced 21,22,23] \
        [--out <file.jsonl>]

Runs each seed of ``--sets`` with ``--trace 0``, ``--repeat`` times over
(set after set, the same seeds in each), then each seed of ``--traced``
with ``--trace 1``, one after another with the benchmark's own command.
Prints each run's last line, then each metric's median and spread (the
distance between the quartiles as a share of the median) per set.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

from h100bench import stats


def one(workload: str, seed: int, seconds: float, traced: int,
        timeout: float) -> dict:
    cmd = [sys.executable, "-m", "h100bench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(traced)]
    done = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, check=False)
    lines = done.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        result = None
    return {"seed": seed, "trace": traced, "rc": done.returncode,
            "result": result, "stderr": done.stderr[-3000:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", default="")
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--traced", default="")
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.sets.split(",") if s]
    traced = [int(s) for s in args.traced.split(",") if s]
    runs = []
    for rep in range(args.repeat):
        for s in seeds:
            r = one(args.workload, s, args.seconds, 0, args.timeout)
            r["set"] = rep
            runs.append(r)
            print(json.dumps({"set": rep, "seed": s, "rc": r["rc"],
                              "result": r["result"]}), flush=True)
            if r["result"] is None:
                print(r["stderr"], flush=True)
    for s in traced:
        r = one(args.workload, s, args.seconds, 1, args.timeout)
        r["set"] = "traced"
        runs.append(r)
        print(json.dumps({"set": "traced", "seed": s, "rc": r["rc"],
                          "result": r["result"]}), flush=True)
        print(r["stderr"][-1500:], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in runs:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    groups: dict = {}
    for r in runs:
        if r["result"] is None:
            continue
        for name, m in r["result"]["metrics"].items():
            groups.setdefault((r["set"], name), []).append(m["value"])
    for (group, name), values in sorted(groups.items(), key=str):
        line = (f"{args.workload} set {group} {name}: n {len(values)} "
                f"median {statistics.median(values)!r}")
        if len(values) >= 2:
            line += f" spread {stats.spread(values)!r}"
        print(line + f" values {values!r}")
    bad = [r for r in runs if r["result"] is None
           or not r["result"]["correct"]]
    print(f"{args.workload}: {len(runs)} runs, {len(bad)} not correct or "
          "without a result")
    return 0


if __name__ == "__main__":
    sys.exit(main())
