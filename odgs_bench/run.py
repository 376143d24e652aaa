"""Run one cell of the benchmark once and print its result line.

    python3 -m odgs_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The program under test is
open_diffusiongs_tpu_torch on the CUDA card(s) of this machine; the cell's
configuration, traffic and check are found by name from BENCHMARK.json
(odgs_bench/harness.py).  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device, with --trace 1 a
breakdown, and last the check's numbers beside their limits, which also
close standard error.

The cell's kind (its traffic's `kind`) names the module under
odgs_bench/kinds/ that runs it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "open_diffusiongs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(f"odgs_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")


def args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m odgs_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def device_info(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def checks(gaps: dict, limits: dict) -> dict:
    return {k: {"value": gaps[k], "limit": limits[k]} for k in limits}


def verdict(c: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in c.values())


def main(argv=None) -> int:
    a = args_parser().parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").is_file():
        fail("run from the root of a checkout: BENCHMARK.json is missing")
    cache_dirs(root)
    try:
        import open_diffusiongs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program under test cannot be imported: {e}")
    import torch
    from . import harness
    spec = harness.load_spec(root)
    cell = harness.cell(spec, root, a.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        fail(f"{a.workload} needs {chips} cards, "
             f"{torch.cuda.device_count()} found")
    try:
        kind = harness.kind(cell)
    except KeyError as e:
        fail(str(e))
    res = kind.run(cell, a.seed, a.seconds, bool(a.trace), T_START,
                   torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        fail(f"the run loaded {', '.join(bad)}")
    out = result(cell, res, bool(a.trace), device_info(
        torch, chips, res["memory_peak_bytes"]))
    w = res["window"]
    if a.trace:
        print("trace kernels (launches, s): " + json.dumps(
            w["trace"]["kernels"]), file=sys.stderr)
        print(f"trace: {w['trace']['events']} device events reduced in "
              f"{w['trace']['reduce_s']:.1f} s; phases "
              f"{json.dumps(w['trace']['phases'])}; stages "
              f"{json.dumps(w.get('stage_seconds'))}", file=sys.stderr)
    print(kind.window_line(res), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def result(cell: dict, res: dict, traced: bool, device: dict) -> dict:
    """The result line of a run: the verdict, the cell's end-to-end
    metrics (traced: its per-layer metrics, the device's busy and window
    seconds and the breakdown), and last the check's numbers."""
    from . import harness
    c = checks(res["gaps"], cell["check"]["limits"])
    ok = verdict(c)
    out = {"correct": ok, "attempted": res["attempted"],
           "failed": 0 if ok else 1}
    w = res["window"]
    if traced:
        ctx = dict(w, config=cell["config"], traffic=cell["traffic"])
        out["metrics"] = harness.read_metrics(
            cell["metrics"]["per_layer"], ctx)
        device = dict(device, busy_s=w["trace"]["busy_s"],
                      window_s=w["trace"]["window_s"])
        out["breakdown"] = {"device_ops": w["trace"]["device_ops"],
                            "idle_gaps": w["trace"]["idle_gaps"]}
    else:
        # an end-to-end metric is its quantity's (the name up to its
        # first dot), named for the cell
        vals = dict(harness.kind(cell).e2e(res), setup_s=res["setup_s"],
                    memory_peak_gb=res["memory_peak_bytes"] / 1e9)
        out["metrics"] = {m["name"]: {"value": vals[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
                          for m in cell["metrics"]["end_to_end"]}
    out["device"] = device
    out["checks"] = c
    return out


if __name__ == "__main__":
    sys.exit(main())
