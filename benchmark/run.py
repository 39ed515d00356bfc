"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload dragon7.wavefront --seed 1234 --seconds 10 --trace 0

The last line of standard output is the result as one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, then ``host``: how the host ran the
window, and ``checks`` last: each number compared with its limit); the last
lines of standard error repeat the numbers compared.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics: the
device's from a profiler trace of CUDA activity over the first passes, the
program's host ranges on the host clock over the passes after those.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; if the JAX package or JAX is loaded once
the window has closed, with code 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "owl_path_tracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import drive

    cell = drive.load_cell(args.workload)
    drive.cache_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    result = drive.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
