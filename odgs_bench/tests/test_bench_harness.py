"""The harness finds every part of a cell by name, a new cell needs only
new files, the counts reproduce the kernels' bounds, and nothing the run
reaches is JAX or the JAX package."""

import ast
import json
import subprocess
import sys

import pytest

from odgs_bench import counts, harness, trace

ROOT = harness.HERE.parent

FORBIDDEN = {"jax", "jaxlib", "flax", "open_diffusiongs_tpu"}


def test_every_cell_resolves(spec):
    names = {m["name"] for m in spec["per_layer"]}
    for w in spec["workloads"]:
        c = harness.cell(spec, ROOT, w["name"])
        assert c["config"]["system_type"] == "diffusion-gs-system"
        kind = harness.kind(c)
        assert all(hasattr(kind, f) for f in ("run", "e2e", "window_line",
                                              "readings"))
        assert c["metrics"]["per_layer"]
        assert {m["name"] for m in c["metrics"]["end_to_end"]} >= {
            "setup_s"}
    for n in names:
        assert hasattr(harness.reader(n), "read"), n
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert hasattr(harness.reference(cfg["reference"]), "dit_forward")


def test_a_new_cell_is_files_only(tmp_path, spec):
    here = tmp_path / "bench"
    for d in ("traffic", "workloads", "metrics", "configs"):
        (here / d).mkdir(parents=True)
    src = ROOT / "odgs_bench"
    (here / "configs" / "x.json").write_text(
        (src / "configs" / "diffusionGS_rel.json").read_text())
    (here / "traffic" / "two.json").write_text(json.dumps(
        {"kind": "sample", "batch": 2}))
    (here / "workloads" / "x.two.json").write_text(json.dumps(
        {"limits": {"start_gap": 0.0}}))
    (here / "metrics" / "calls.x.py").write_text(
        "def read(ctx):\n    return ctx['calls'] or None\n")
    spec = dict(spec)
    spec["configs"] = spec["configs"] + [
        {"name": "x", "source": "s", "file": "bench/configs/x.json",
         "reduced": [], "why": "w"}]
    spec["workloads"] = spec["workloads"] + [
        {"name": "x.two", "config": "x", "traffic": "two", "chips": 1,
         "why": "w"}]
    spec["per_layer"] = spec["per_layer"] + [
        {"name": "calls.x", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "Pipeline",
         "moves": "assets_per_s.obj256", "workloads": ["x.two"]}]
    spec["end_to_end"] = spec["end_to_end"] + [
        {"name": "assets_per_s.x", "unit": "assets/s", "better": "higher",
         "bound": 0.1, "source": "host_clock", "workloads": ["x.two"]}]
    c = harness.cell(spec, tmp_path, "x.two", here=here)
    assert c["traffic"]["batch"] == 2
    assert [m["name"] for m in c["metrics"]["per_layer"]] == ["calls.x"]
    assert sorted(m["name"] for m in c["metrics"]["end_to_end"]) == [
        "assets_per_s.x", "setup_s"]
    got = harness.read_metrics(c["metrics"]["per_layer"], {"calls": 3},
                               here=here)
    assert got == {"calls.x": {"value": 3.0, "unit": "calls"}}
    assert harness.read_metrics(c["metrics"]["per_layer"], {"calls": 0},
                                here=here) == {}
    assert harness.kind(c).__name__ == "odgs_bench.kinds.sample"
    # a new cell's metric of a quantity that has a reader needs no file
    idle = harness.reader("device_idle_pct.x.two")
    assert idle.read({"trace": {"window_s": 2.0, "busy_s": 1.5}}) == 25.0


@pytest.mark.parametrize("op,b,want_ms", [
    ("fwd", 1, 0.0696), ("fwd_stats", 4, 0.278), ("bwd", 4, 0.696)])
def test_counts_reproduce_the_kernel_bounds(op, b, want_ms):
    f = {"fwd": counts.attn_fwd, "fwd_stats": counts.attn_fwd_stats,
         "bwd": counts.attn_bwd}[op]
    l = counts.tokens({"n_gaussians": 2, "patch_size": 8}, 256, 4)
    assert l == 4098
    assert 1e3 * counts.bound_s(*f(b, l, 16, 64)) == pytest.approx(
        want_ms, rel=2e-3)


def test_dit_flops_per_asset():
    sm = {"width": 1024, "num_layers": 24, "n_gaussians": 2, "patch_size": 8}
    per_asset = 30 * counts.dit_flops(sm, counts.tokens(sm, 256, 4))
    assert 1.2e14 < per_asset < 1.3e14


def test_trace_summary_phases_union_and_gaps():
    m = trace.MARKER
    dev = [(0, 1, m), (2, 10, "upload"), (11, 12, m), (15, 25, "gemm"),
           (20, 30, "attn"), (31, 32, m), (40, 50, "sort"), (60, 61, m),
           (70, 80, "gemm")]
    s = trace.summarize(dev, ["pipeline", "denoiser", "render", "denoiser"],
                        1e-7)
    assert s["phases"] == pytest.approx(
        {"pipeline": 8e-9, "denoiser": 30e-9, "render": 10e-9})
    assert s["busy_s"] == pytest.approx(8e-9 + 15e-9 + 10e-9 + 10e-9)
    assert s["kernels"]["gemm"][0] == 2
    assert s["idle_gaps"][0] == ["host: DiT launches: all 2 gaps",
                                 pytest.approx(25e-9)]
    assert s["idle_gaps"][2] == ["host: DiT launches: one gap",
                                 pytest.approx(20e-9)]
    with pytest.raises(RuntimeError):
        trace.summarize(dev, ["pipeline"], 1e-7)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "odgs_bench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    for path in (ROOT / "odgs_bench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "open_diffusiongs_tpu_torch" not in tops, path


def test_the_run_loads_no_jax_module():
    code = (
        "import sys, runpy\n"
        "from odgs_bench import run, readings, trace, harness, counts\n"
        "from odgs_bench.kinds import sample, train\n"
        "from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline\n"
        "from open_diffusiongs_tpu_torch.systems import builder\n"
        "spec = harness.load_spec(harness.HERE.parent)\n"
        "for m in spec['per_layer']: harness.reader(m['name'])\n"
        "harness.reference('dgs_object')\n"
        "print(','.join(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""


def test_run_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "odgs_bench.run", "--workload",
         "obj256.sample_b4", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_every_reader_reads_a_trace(spec):
    """Each per-layer metric's reader gives a positive number from a trace
    summary of its own cell's kind."""
    kernels = {"flash_fwd_kernel<64, false, false>(FwdParams)": [720, 0.14],
               "flash_fwd_kernel<64, true, false>(FwdParams)": [48, 0.04],
               "flash_bwd_dq_kernel(BwdParams)": [24, 0.03],
               "flash_bwd_dkv_kernel(BwdParams)": [24, 0.04],
               "sm90_xmma_fprop_implicit_gemm_f32f32": [26, 0.05]}
    tr = {"window_s": 10.0, "busy_s": 6.0, "kernels": kernels,
          "phases": {"denoiser": 3.0, "render": 1.0, "step": 6.0,
                     "lpips": 1.5}}
    for m in spec["per_layer"]:
        c = harness.cell(spec, ROOT, m["workloads"][0])
        ctx = {"trace": tr, "config": c["config"], "traffic": c["traffic"],
               "calls": 2, "assets": 2, "steps": 2, "samples": 2,
               "stage_seconds": {"sampler": 8.0, "filters": 0.2}}
        v = harness.reader(m["name"]).read(ctx)
        assert v is not None and v > 0, m["name"]
