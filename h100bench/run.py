"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress and the compared numbers on standard error and, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number beside its
limit).  Exits non-zero, printing no result, where there is no CUDA card,
fewer cards than the cell asks for, or where the process imported JAX or
the JAX package.
"""

import time

T_PROCESS = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _jax_loaded() -> list[str]:
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "smfft_tpu" or m.startswith("smfft_tpu."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    print(f"import torch: {(time.perf_counter_ns() - T_PROCESS) / 1e9:.3f} s",
          file=sys.stderr, flush=True)

    from h100bench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("h100bench: no CUDA device; this benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS)
    loaded = _jax_loaded()
    if loaded:
        print(f"h100bench: the run imported {loaded[:5]}; the port's "
              "benchmark imports neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
