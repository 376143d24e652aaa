"""Run docs/CONVERGENCE.md's training protocol for the object or the scene
recipe through `launch --train`, with a resume leg, and summarise it.

  python -m open_diffusiongs_tpu_torch.tools.train_protocol \\
      --recipe object --tree outputs/synth_obja --out outputs/protocol \\
      --max-steps 3000 [--resume-steps 100] [--json run.json] \\
      [--device cuda] [key=value ...]

The tree is one the port's generators write (`make_synthetic_objaverse`
for `object`, `make_synthetic_re10k` for `scene`).  The protocol: the
recipe's config (`configs/diffusionGS_rel.yaml`, or
`configs/diffusionGS_scene.yaml`), batch 1, LPIPS off, lr 5e-5, the
fixed-batch eval every 50 steps; then the caller's dotlist overrides.
Both legs run `launch.main` in this process, into one trial dir
(`{out}/protocol_{recipe}/run`):

  1. train to `--max-steps` (one checkpoint, at the end);
  2. the final state's fixed-batch eval taken apart by its t draws: at
     the port's own four (`launch.EVAL_SEEDS`, drawn in train_loss's
     order, noise then t; the PSNR from them must equal the eval that
     leg 1 logged at its last step bit for bit), at the four that JAX's
     launch draws (JAX_EVAL_T) and at each t of SWEEP_T, always with the
     port's noise;
  3. on the GPU, PROFILE_STEPS more steps of the final state through
     leg 1's own step on its last batch, in memory: host seconds a step
     without and with torch.profiler, and the profiled steps' device ms
     and idle share (nothing is saved);
  4. resume from the checkpoint for `--resume-steps` more; the eval right
     after the restore must equal the eval at the save bit for bit.

The summary (printed as one JSON line, and written to `--json`) holds
every eval row, the rows at REPORT_STEPS, the eval PSNR's minimum
over steps 0-150 and its gain by step 600 and by the end, steps/s of the
logged windows without an eval, the loader's wait, the peak device
memory, the eval draws, the profiled steps, the overflow counters and
the legs' seconds.  Raises on a non-finite metric, on eval draws that
do not reproduce the logged eval, or on a restore whose eval differs.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECIPES = {
    "object": ("configs/diffusionGS_rel.yaml",
               lambda tree: [f"data.local_dir={tree}/meta",
                             f"data.image_dir={tree}/images/"]),
    "scene": ("configs/diffusionGS_scene.yaml",
              lambda tree: [f"data.local_dir={tree}/full_list.txt",
                            f"data.local_eval_dir={tree}/full_list.txt"]),
}
PROTOCOL = ["data.batch_size=1", "system.use_lpips=false",
            "system.loss.lambda_lpips=0.0", "system.optimizer.args.lr=5.e-5",
            "trainer.eval_every_n_steps=50"]
# docs/CONVERGENCE.md's decimated rows, and 400 (the scene table's)
REPORT_STEPS = (0, 150, 300, 400, 600, 800, 900, 1200, 1500, 1800, 2100,
                2400, 2700, 3000)
PROFILE_STEPS = 3
# the t of JAX launch's fixed-batch eval at b = 1: its keys PRNGKey(10_000
# + i) (launch.py:267) split as train_loss splits them (object_system.py:
# 168-170); tests/test_torch_train_protocol.py holds them against JAX
JAX_EVAL_T = (356, 371, 730, 684)
SWEEP_T = (0, 100, 250, 500, 750, 999)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def read_rows(path: str) -> list:
    """A metrics CSV as dicts of floats (step as int)."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [{k: (int(v) if k == "step" else float(v)) for k, v in r.items()}
            for r in rows]


def eval_draws(record: dict, device) -> dict:
    """The fixed-batch eval PSNR of a `launch --train` record's final
    state at the port's t draws, at JAX_EVAL_T and at each t of SWEEP_T,
    with the port's noise (one process)."""
    import torch

    from ..launch import EVAL_SEEDS, EVAL_STEP, generator
    system, batch = record["system"], record["eval_batch"]
    shape = batch["rgbs_input"].shape
    draws = []
    for s in EVAL_SEEDS:            # train_loss's order: noise, then t
        g = generator(device, s)
        noise = torch.randn(shape, generator=g, dtype=torch.float32,
                            device=device)
        draws.append((noise, torch.randint(
            0, system.cfg.num_train_timesteps, shape[:1], generator=g,
            device=device)))

    def psnr(t_of) -> float:
        """The four draws' mean PSNR, rounded as launch logs it (f32)."""
        with torch.no_grad():
            return float(torch.stack([
                system.train_loss(batch, EVAL_STEP, noise=noise,
                                  t=t_of(i, t))[1]["psnr"].double()
                for i, (noise, t) in enumerate(draws)]).mean().float())

    def fixed(value):
        return torch.full(shape[:1], value, dtype=torch.long, device=device)

    return {"port_t": [t.tolist() for _, t in draws],
            "jax_t": list(JAX_EVAL_T),
            "psnr_port_t": psnr(lambda i, t: t),
            "psnr_jax_t": psnr(lambda i, t: fixed(JAX_EVAL_T[i])),
            "psnr_by_t": {v: psnr(lambda i, t: fixed(v)) for v in SWEEP_T}}


def profile_steps(record: dict, device, n: int) -> dict:
    """Host seconds a step over `n` steps of a `launch --train` record's
    final state through its own step on its last batch, in memory, without
    and then with torch.profiler; the profiled steps' device ms and the
    share of their host time the device idles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step_fn, state, batch = (record[k] for k in ("step_fn", "state",
                                                 "batch"))

    def run():
        nonlocal state
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / n

    run()                                           # warm-up
    secs = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs_profiled = run()
    device_ms = sum(e.self_device_time_total
                    for e in prof.key_averages()) / 1e3 / n
    return {"seconds_per_step": secs, "steps": n,
            "seconds_per_step_profiled": secs_profiled,
            "device_ms_per_step": device_ms,
            "idle_share_profiled": 1.0 - device_ms / 1e3 / secs_profiled}


def summarize(trial: str, eval_every: int, log_every: int,
              save_step: int) -> dict:
    """The curve, the rows at REPORT_STEPS, the gains, steps/s and the
    loader's wait from a trial dir's CSVs; `save_step` is the resume's
    step (-1 for none)."""
    evals = read_rows(os.path.join(trial, "eval_metrics.csv"))
    train = read_rows(os.path.join(trial, "metrics.csv"))
    bad = [r["step"] for r in evals + train
           if not all(v == v and abs(v) != float("inf") for v in r.values())]
    if bad:
        raise AssertionError(f"non-finite metrics at steps {bad}")
    curve = [{k: r[k] for k in ("step", "psnr", "loss", "overflow_frac",
                                "overflow_tiles", "overflow_gaussians")}
             for r in evals]
    first = {}
    for r in curve:                      # the resume leg repeats save_step
        first.setdefault(r["step"], r)
    psnr = {s: r["psnr"] for s, r in first.items()}
    early = [v for s, v in psnr.items() if s <= 150]
    # a logged window (step - log_every, step] with no eval in it
    clean = [r["steps_per_sec"] for r in train
             if r["step"] % log_every == 0
             and r["step"] // eval_every == (r["step"] - log_every) // eval_every
             and r["step"] != save_step + 1]
    last = max(psnr)
    return {
        "curve": curve,
        "at_steps": {s: first[s] for s in REPORT_STEPS if s in first},
        "psnr_min_0_150": min(early),
        "psnr_step0": psnr[0],
        "psnr_600": psnr.get(600),
        "gain_600_over_min_0_150": (psnr[600] - min(early)
                                    if 600 in psnr else None),
        "gain_400_over_step0": (psnr[400] - psnr[0] if 400 in psnr
                                else None),
        "last_step": last, "psnr_last": psnr[last],
        "steps_per_sec_median": statistics.median(clean) if clean else None,
        "steps_per_sec_windows": len(clean),
        "loader_wait_s_total": sum(r["loader_wait_s"] for r in train),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    ap.add_argument("--tree", required=True,
                    help="the generator's --out directory")
    ap.add_argument("--out", required=True, help="exp_root_dir")
    ap.add_argument("--max-steps", type=int, required=True)
    ap.add_argument("--resume-steps", type=int, default=100)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args, extra = ap.parse_known_args(argv)

    import torch

    from .. import launch, select_device
    from ..utils.config import load_config

    dev = select_device(args.device)
    config, data = RECIPES[args.recipe]
    config = os.path.join(ROOT, config)
    overrides = [*data(os.path.abspath(args.tree)), *PROTOCOL,
                 f"exp_root_dir={args.out}", f"name=protocol_{args.recipe}",
                 "tag=run", "use_timestamp=false",
                 "checkpoint.every_n_train_steps=1000000000", *extra]
    cfg = load_config(config, cli_args=overrides, makedirs=False)
    eval_every = int(cfg.trainer["eval_every_n_steps"])
    if args.max_steps % eval_every:
        ap.error("--max-steps must be a multiple of eval_every_n_steps (the "
                 "eval at the save is compared with the eval after the "
                 "restore)")
    base = ["--config", config, "--train", "--device", str(dev), *overrides]
    on_gpu = dev.type == "cuda"

    def leg(argv_leg):
        if on_gpu:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        record = launch.main(argv_leg)
        if on_gpu:
            torch.cuda.synchronize(dev)
        return record, {
            "seconds": time.perf_counter() - t0,
            "stages": dict(record["seconds"]),
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(dev) if on_gpu else None,
            "max_memory_reserved_bytes":
                torch.cuda.max_memory_reserved(dev) if on_gpu else None}

    record, leg1 = leg(base + ["--max_steps", str(args.max_steps)])
    trial = record["trial_dir"]
    draws = eval_draws(record, dev)
    logged = [r for r in read_rows(os.path.join(trial, "eval_metrics.csv"))
              if r["step"] == args.max_steps]
    draws["reproduces_logged_eval"] = (
        len(logged) == 1 and draws["psnr_port_t"] == logged[0]["psnr"])
    prof = (profile_steps(record, dev, PROFILE_STEPS) if on_gpu else None)
    record.clear()
    if on_gpu:
        torch.cuda.empty_cache()
    out = {"recipe": args.recipe, "config": os.path.relpath(config, ROOT),
           "overrides": overrides, "trial_dir": trial, "device": str(dev),
           "card": card_line() if on_gpu else None,
           "max_steps": args.max_steps, "leg1": leg1,
           "eval_draws": draws, "profile": prof}
    if args.resume_steps:
        record, leg2 = leg(base + ["--max_steps",
                                   str(args.max_steps + args.resume_steps),
                                   f"resume={trial}/ckpts"])
        record.clear()
        with open(os.path.join(trial, "eval_metrics.csv")) as f:
            rows = [r for r in csv.reader(f) if r]
        at_save = [r for r in rows[1:] if r[0] == str(args.max_steps)]
        out["leg2"] = leg2
        out["resume_eval_rows"] = at_save
        out["resume_eval_equal"] = (len(at_save) == 2
                                    and at_save[0] == at_save[1])
    out.update(summarize(trial, eval_every,
                         int(cfg.trainer.get("log_every_n_steps", 5)),
                         args.max_steps if args.resume_steps else -1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "curve"}),
          flush=True)
    if not draws["reproduces_logged_eval"]:
        raise AssertionError(f"the eval draws give {draws['psnr_port_t']}, "
                             f"leg 1 logged {logged}")
    if args.resume_steps and not out["resume_eval_equal"]:
        raise AssertionError(f"the eval after the restore differs from the "
                             f"eval at the save: {out['resume_eval_rows']}")
    return out


if __name__ == "__main__":
    main()
