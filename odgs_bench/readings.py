"""The check's numbers over many seeds, for setting its limits; not run by
the benchmark's own runs.

    python3 -m odgs_bench.readings --workload <cell> --seed <n> \
        --count <k> [--control w8a8]

prints one JSON line a seed: the program's gaps (sampling: beside those
of the control a precision lower, from the same captured call; the
training control runs in odgs_bench/tests, marked `card`).
`--control w8a8` runs a sampling cell's program on its own int8 serving
path.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import harness, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m odgs_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--count", type=int, default=12)
    p.add_argument("--control", choices=("w8a8",), default=None)
    a = p.parse_args(argv)
    root = Path.cwd()
    run.cache_dirs(root)
    import torch
    if not torch.cuda.is_available():
        run.fail("no CUDA device: the readings run on the card only")
    cell = harness.cell(harness.load_spec(root), root, a.workload)
    opts = {"control": a.control} if a.control else {}
    for row in harness.kind(cell).readings(cell, a.seed, a.count,
                                           torch.device("cuda", 0), **opts):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
