#!/usr/bin/env python3
"""Readings from which a cell's limits are set, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control 3] [--fault altered_token|half_batch|frozen_step] [--out file.jsonl]

For each seed: the cell's set-up and a short window at its own size and load, then the
numbers its check compares, without limits (the program's readings: their largest over
a dozen seeds or more is a limit's lower reading). With `--control n`, on the first n
seeds also the control's numbers, one precision below the configuration's, as the cell
file's `control` names it: the program's own lower-precision path where it has one
(`program`: the configuration groups it overrides; training: the trainer's bf16 step),
run and checked as the program is; else the reference put in the program's place
(`precision`; synthesis: the text model's operands in bf16, the generator's in fp8);
their smallest is a limit's upper reading.
With `--fault`, the program runs with that fault planted (`benchmark/faults.py`). One
JSON line per seed on standard output, and in `--out`."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def with_overrides(config: dict, overrides: dict) -> dict:
    """`config` with each group of `overrides` merged over its own group."""
    out = dict(config)
    for k, v in overrides.items():
        out[k] = {**config[k], **v} if isinstance(v, dict) else v
    return out


def control_numbers(bench, workload: str, runner, seed: int, device, seconds: float) -> dict:
    """The control's numbers on `seed`; `runner` is the program's, already checked."""
    from benchmark.harness import window

    cell = bench.cell(workload)
    ctl = cell["control"]
    if "program" not in ctl:
        return runner.control(**ctl)
    config = with_overrides(bench.config(bench.entry(workload)["config"]), ctl["program"])
    traffic = bench.traffic(cell["kind"]).Traffic(cell["params"], config, seed)
    other = bench.runner(cell["runner"]).Runner(cell, config, traffic, seed, device)
    other.setup()
    window(other, seconds, other.first_unit)
    other.free()
    numbers = other.check()
    runner.control_detail = getattr(other, "detail", None)
    return numbers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import contextlib

    import torch

    from benchmark.runners.common import free_cuda
    from benchmark.faults import FAULTS
    from benchmark.harness import Bench, card_line, window

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    bench = Bench(ROOT)
    entry = bench.entry(args.workload)
    cell = bench.cell(args.workload)
    config = bench.config(entry["config"])
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        traffic = bench.traffic(cell["kind"]).Traffic(cell["params"], config, seed)
        runner = bench.runner(cell["runner"]).Runner(cell, config, traffic, seed, device)
        fault = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        with fault:
            runner.setup()
            runner.sync()
            setup_s = time.perf_counter() - t0
            records, elapsed = window(runner, args.seconds, runner.first_unit)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "setup_s": setup_s, "units": len(records), "elapsed_s": elapsed,
                "failed": runner.failed(records)}
        runner.free()
        t1 = time.perf_counter()
        line["numbers"] = runner.check()
        line["check_s"] = time.perf_counter() - t1
        line.update({k: v for k, v in vars(runner).items() if k in ("detail",)})
        if n < args.control:
            t1 = time.perf_counter()
            line["control"] = control_numbers(bench, args.workload, runner, seed, device,
                                              args.seconds)
            line["control_s"] = time.perf_counter() - t1
            line.update({k: v for k, v in vars(runner).items() if k == "control_detail"})
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del runner, traffic
        free_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main())
