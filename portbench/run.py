#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is a workload of ``BENCHMARK.json``;
its pieces are found by name under ``portbench/`` (``harness``). The run
builds its inputs from the seed, warms up (set-up), then measures for
``--seconds`` seconds (``--trace 0``: the cell's end-to-end metrics) or
traces a fixed number of frames (``--trace 1``: its
per-layer metrics), judges what the timed path produced against the plain
reference, and prints one JSON line last on standard output, with the
numbers compared and their limits as the last lines of standard error. It
needs CUDA: without a card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of kernels a program compiles stay inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(REPO / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
    sys.path.insert(0, str(REPO))

    import torch

    from portbench import harness

    with open(REPO / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cell = harness.find_cell(manifest, args.workload, REPO)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from portbench import program

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                      program, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    out["device"]["power_limit"] = power_limit()
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
