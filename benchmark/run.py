#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the result: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` a `breakdown`, and last `checks`, each number
the check compared beside its limit (also the last lines of standard error). With no
card, too few cards, a missing file or a module of JAX loaded, it prints no result and
exits with 1."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", required=True, type=int, choices=(0, 1))
    args = ap.parse_args()

    # every cache of the program inside the checkout, at fixed paths; the port's
    # kernels build into ttscube_tpu_torch/_build/, also inside it
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from benchmark.harness import RunError, run

    try:
        result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
