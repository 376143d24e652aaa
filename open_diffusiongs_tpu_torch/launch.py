"""Training / evaluation CLI on the GPU: the port of launch.py.

  python -m open_diffusiongs_tpu_torch.launch \
      --config configs/diffusionGS_rel.yaml --train [a.b=c ...]
  python -m open_diffusiongs_tpu_torch.launch \
      --config configs/diffusionGS_scene_eval.yaml --validate \
      resume=outputs/.../ckpts

The flags and the trial directory are those of the JAX package's
launch.py (:28-553): cmd.txt, parsed.yaml and a code snapshot in the trial
dir; `init_params`, then the config's weight bootstraps, then the resume
restore; metrics.csv with a line at the first step after every (re)start;
the fixed-batch eval every trainer.eval_every_n_steps into
eval_metrics.csv; a checkpoint each every_n_train_steps and at the end;
optional TensorBoard and wandb loggers; validate / test / export
artifacts.  `--device` (default cuda; raises without a GPU) replaces
`--platform`.

Several processes (JAX launch.py:104-118, 172-197): run under torchrun,
    torchrun --nproc_per_node N -m open_diffusiongs_tpu_torch.launch \
        --config ... --train trainer.seq_parallel=2 trainer.zero1=true
each rank takes card LOCAL_RANK (parallel/mesh.py::init_mesh; backend
nccl, or gloo on the CPU; `--dist-backend gloo` for ranks that share a
card).  trainer.pipe_parallel, seq_parallel and model_parallel lay the
world out as dp = N / (pp·sp·tp) data rows of pp GPipe stages x sp ring
ranks x tp tensor-parallel ranks (pipe_parallel composes with data
parallelism only, as in JAX); the global batch is data.batch_size × dp,
of which each data rank loads its slice.  Rank 0 alone writes cmd.txt,
parsed.yaml, the code snapshot, metrics.csv, eval_metrics.csv, the loggers,
the progress file and the checkpoints (gathered from every rank first);
logged metrics are averaged over the data ranks.  --validate / --test /
--export shard the scenes over the data ranks (the first rank of each data
row writes its scenes' artifacts).

Randomness: the draws of training step s come from a generator seeded by
(seed + 1, s) (JAX folds its key by the step), so a resumed run draws what
an uninterrupted one would, and every rank draws the global batch's
(systems/object_system.py); eval pass i draws from seed 10_000 + i;
validate and export draw from (seed + 2 | seed + 3, dataset index); numpy's
global seed is seed + rank (JAX launch.py:172-173).
Metrics stay device tensors and are read at log steps only.

Deviations from the JAX module:
  * the fixed eval batch is collated in the main thread from a fresh
    dataset instance at the indices of the loader's first batch; JAX takes
    the first batch its loader threads deliver, whose draws depend on the
    threads' order;
  * metrics.csv also holds loader_wait_s, the host seconds the loop
    waited on the loader since the previous log line;
  * `main` returns a record of the run (trial dir, state, system, mesh,
    host seconds of its stages) for in-process callers, whose process
    group stays up (the CLI tears it down at exit).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fixed eval's draws (JAX launch.py:267) and its step, at which every
# C()-scheduled loss term has its final weight
EVAL_SEEDS = tuple(10_000 + i for i in range(4))
EVAL_STEP = 10 ** 6


def fold_seed(seed: int, i: int) -> int:
    """A 64-bit seed for draw `i` of the stream `seed` (jax.random.fold_in's
    role)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint64)[0])


def generator(device, seed: int, i: Optional[int] = None):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed if i is None else fold_seed(seed, i))
    return g


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The array fields of a collated batch as tensors on `device`; to a
    GPU through pinned memory, asynchronously (a copy from pageable memory
    would wait for the stream's earlier work: a host sync per step)."""
    import torch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(device, non_blocking=True)
                      if device.type == "cuda" else t)
    return out


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--export", action="store_true",
                        help="asset export from a resumed ckpt: renders grid "
                             "PNG, PLY and a path video per scene")
    parser.add_argument("--use_ema", action="store_true",
                        help="use EMA weights for validate/test/export")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--gradio", action="store_true",
                        help="write a single-line progress file to "
                             "<trial_dir>/progress")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--dist-backend", default=None,
                        help="torch.distributed backend of a multi-process "
                             "run: nccl (default on cuda) or gloo (the CPU, "
                             "or ranks sharing one card)")
    parser.add_argument("--dist-init", default="env://",
                        help="init_method of a multi-process run (default: "
                             "torchrun's env://)")
    args, extras = parser.parse_known_args(argv)
    if not (args.train or args.validate or args.test or args.export):
        parser.error("one of --train / --validate / --test / --export "
                     "is required")

    import dataclasses

    from . import _register_builtins, find, select_device
    from .parallel.mesh import check_parallelism, init_mesh
    from .utils.timing import StageClock
    from .parallel.train_step import init_train_state, make_optimizer
    from .systems.builder import build_optimizer_config, build_system
    from .utils.checkpoint import CheckpointManager
    from .utils.config import dump_config, load_config

    device = select_device(args.device)
    _register_builtins()
    cfg = load_config(args.config, cli_args=extras, makedirs=False)
    trainer_cfg = dict(cfg.trainer)
    _, pp, sp, tp = check_parallelism(trainer_cfg,
                                      int(os.environ.get("WORLD_SIZE", 1)))
    mesh = init_mesh(seq_parallel=sp, model_parallel=tp, pipe_parallel=pp,
                     device_type=device.type, backend=args.dist_backend,
                     init_method=args.dist_init)
    device = mesh.device
    if mesh.world > 1:   # one trial dir: rank 0's timestamp
        cfg = dataclasses.replace(cfg, timestamp=_broadcast(cfg.timestamp))

    # --- reproducibility + snapshots (launch.py:172-173, 262-267) ---------
    np.random.seed(cfg.seed + mesh.rank)
    if mesh.is_main:
        os.makedirs(cfg.trial_dir, exist_ok=True)
        cmd = (sys.argv if argv is None else
               ["-m", "open_diffusiongs_tpu_torch.launch", *argv])
        with open(os.path.join(cfg.trial_dir, "cmd.txt"), "w") as f:
            f.write(" ".join(["python"] + list(cmd)))
        dump_config(os.path.join(cfg.trial_dir, "parsed.yaml"), cfg)
        _snapshot_code(cfg.trial_dir)

    bf16 = str(trainer_cfg.get("precision", "bf16")) in (
        "16-mixed", "bf16", "bf16-mixed", "16")
    # host seconds of the run's stages, closed at synchronized edges
    record: Dict[str, Any] = {"trial_dir": cfg.trial_dir, "seconds": {}}
    clock = StageClock(record["seconds"], device)

    # --- data, system, optimizer, state -----------------------------------
    data_cls = find(cfg.data_type)
    dataset = data_cls(cfg.data, split="train" if args.train else "test",
                       seed=cfg.seed)
    system = build_system(cfg.system_type, cfg.system, bf16=bf16,
                          device=device, mesh=mesh)
    system.init_params(generator(device, cfg.seed))
    # stage-2-from-stage-1 / partial weight bootstrap (overridden by resume)
    system.load_pretrained()
    params = dict(system.model.named_parameters())
    optimizer = make_optimizer(build_optimizer_config(cfg.system,
                                                      trainer_cfg),
                               params.items(), mesh=mesh,
                               zero1=bool(trainer_cfg.get("zero1", False)))
    state = init_train_state(params, optimizer, ema_decay=0.9999)
    clock.stage("setup")

    ckpt = CheckpointManager(
        os.path.join(cfg.trial_dir, "ckpts"),
        every_n_train_steps=dict(cfg.checkpoint).get("every_n_train_steps",
                                                     1000), mesh=mesh)
    if cfg.resume:
        resume_mngr = (CheckpointManager(cfg.resume, mesh=mesh)
                       if os.path.abspath(cfg.resume) != ckpt.directory
                       else ckpt)
        state = resume_mngr.restore(state)
        clock.stage("restore")
        _print(mesh, f"Resumed from {cfg.resume} at step {state.step} "
                     f"({record['seconds']['restore']:.3f} s)")

    record.update(mesh=mesh)
    if args.train:
        state = train(cfg, args, system, state, dataset, ckpt, device,
                      record)
        if args.gradio:
            # gradio mode also exports assets after training
            # (reference launch.py:287-289)
            export(cfg, args, system, state, dataset, device, record)
    elif args.validate or args.test:
        validate(cfg, args, system, state, dataset, device, record)
    else:
        export(cfg, args, system, state, dataset, device, record)
    record.update(state=state, system=system)
    return record


def _print(mesh, line: str) -> None:
    """A log line, from rank 0 only."""
    if mesh.is_main:
        print(line, flush=True)


def _broadcast(value):
    """Rank 0's value of a picklable object, on every rank."""
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def train(cfg, args, system, state, dataset, ckpt, device, record):
    from .data.loader import PrefetchLoader, collate
    from .parallel.mesh import local_batch_slice
    from .parallel.train_step import make_train_step

    mesh = record["mesh"]
    trainer_cfg = dict(cfg.trainer)
    log_every = int(trainer_cfg.get("log_every_n_steps", 5))
    max_steps = args.max_steps or int(trainer_cfg.get("max_steps", 10 ** 9))
    # data.batch_size per data rank; the index stream is the global batch's,
    # seeded alike on every rank, each loading its slice (JAX :172-183)
    batch_size = int(cfg.data.get("batch_size", 4)) * mesh.dp
    loader = PrefetchLoader(
        dataset, batch_size=batch_size, shuffle=True,
        num_threads=max(1, int(cfg.data.get("num_workers", 2))),
        seed=cfg.seed, process_slice=local_batch_slice(batch_size, mesh))
    step_fn = make_train_step(
        lambda batch, step: system.train_loss(
            batch, step, generator=generator(device, cfg.seed + 1, step)),
        state.optimizer, ema_decay=0.9999)

    t0 = time.perf_counter()
    writer, wandb_run = _loggers(cfg) if mesh.is_main else (None, None)
    record["seconds"]["loggers"] = time.perf_counter() - t0
    csv_path = os.path.join(cfg.trial_dir, "metrics.csv")
    progress = ProgressFile(os.path.join(cfg.trial_dir, "progress")
                            if args.gradio and mesh.is_main else None)
    step = start_step = last_logged_step = state.step
    # deterministic learning signal: every trainer.eval_every_n_steps, the
    # loss on a FIXED batch with FIXED draws, so the eval metrics are a
    # function of the parameters alone (docs/CONVERGENCE.md)
    eval_every = int(trainer_cfg.get("eval_every_n_steps", 0))
    eval_csv = os.path.join(cfg.trial_dir, "eval_metrics.csv")
    eval_batch = None
    if eval_every:
        fresh = type(dataset)(dataset.cfg, split=dataset.split,
                              seed=cfg.seed)
        first = loader.first_batch_indices()[loader.process_slice]
        eval_batch = to_device(collate([fresh[i] for i in first]), device)

    def run_eval():
        import torch
        with torch.no_grad():
            outs = [system.train_loss(eval_batch, EVAL_STEP,
                                      generator=generator(device, s))[1]
                    for s in EVAL_SEEDS]
        m = mesh.mean_metrics({
            k: torch.stack([o[k].double() for o in outs]).mean()
            for k in outs[0]})
        if not mesh.is_main:
            return
        print("eval step {}: {}".format(step, " ".join(
            f"{k}={v:.4g}" for k, v in sorted(m.items()))), flush=True)
        _append_csv(eval_csv, step, m)
        if writer:
            for k, v in m.items():
                writer.add_scalar(f"eval/{k}", v, step)

    if eval_every:
        run_eval()
    t0 = t_wait = time.time()
    loader_wait = 0.0
    device_batch = None
    for batch in loader:
        loader_wait += time.time() - t_wait
        if step >= max_steps:
            break
        device_batch = to_device(batch, device)
        state, metrics = step_fn(state, device_batch)
        step += 1
        if eval_every and step % eval_every == 0:
            run_eval()
        # the `or` term guarantees a log line right after (re)start:
        # resume evidence must not wait a full log_every window
        if step % log_every == 0 or step == start_step + 1:
            m = mesh.mean_metrics(metrics)   # syncs here
            dt = time.time() - t0
            t0 = time.time()
            m["steps_per_sec"] = (step - last_logged_step) / dt
            # host seconds the loop waited on the loader since the last
            # log line (the rest of the window is the steps' own)
            m["loader_wait_s"] = loader_wait
            loader_wait = 0.0
            last_logged_step = step
            if mesh.is_main:
                _write_log(m, step, max_steps, csv_path, progress, writer,
                           wandb_run)
        _save(ckpt, state, step, record)
        t_wait = time.time()
    _save(ckpt, state, step, record, force=True)
    # the loop's own step, its last batch and the eval's batch, for callers
    # that time or re-evaluate the trained state (tools/train_protocol.py)
    record.update(step_fn=step_fn, batch=device_batch, eval_batch=eval_batch)
    if writer:
        writer.close()
    if wandb_run:
        wandb_run.finish()
    _print(mesh, f"training done at step {step}")
    return state


def _write_log(m, step, max_steps, csv_path, progress, writer, wandb_run):
    """A log step's line, metrics.csv row, progress and logger entries."""
    line = " ".join(f"{k}={v:.4g}" for k, v in sorted(m.items()))
    print(f"step {step}: {line}", flush=True)
    # capacity alarm ("no silent caps", docs/CAPACITY.md)
    if m.get("overflow_frac", 0.0) > 0.05:
        print(f"WARNING: rasterizer dropped "
              f"{100 * m['overflow_frac']:.1f}% of per-tile "
              f"entries (> 5%); consider raising "
              f"system.raster.max_per_tile (docs/CAPACITY.md)", flush=True)
    _append_csv(csv_path, step, m)
    progress.write(f"Generation progress: {step / max_steps * 100:.2f}%")
    if writer:
        for k, v in m.items():
            writer.add_scalar(f"train/{k}", v, step)
    if wandb_run:
        wandb_run.log({f"train/{k}": v for k, v in m.items()}, step=step)


def _save(ckpt, state, step, record, force=False) -> None:
    """ckpt.maybe_save, recording the path, bytes and seconds of a save."""
    t0 = time.perf_counter()
    if ckpt.maybe_save(state, force=force, step=step):
        if not ckpt.writes:
            return
        path = os.path.join(ckpt.directory, f"{step}.pt")
        saved = {"path": path, "bytes": os.path.getsize(path),
                 "seconds": time.perf_counter() - t0}
        record.setdefault("saves", []).append(saved)
        print(f"saved checkpoint {path} ({saved['bytes']} bytes, "
              f"{saved['seconds']:.3f} s)", flush=True)


def _loggers(cfg):
    """TensorBoard and wandb, each dropped with a printed line when its
    package (or wandb's network) is unavailable (launch.py:205-228)."""
    writer = wandb_run = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(os.path.join(cfg.trial_dir, "tb"))
    except ImportError as e:
        print(f"tensorboard disabled: {e}")
    wb = dict(dict(cfg.system.get("loggers", {}) or {}).get("wandb", {})
              or {})
    if wb.get("enable", False):
        try:
            import wandb
            wandb_run = wandb.init(
                project=wb.get("project", "open_diffusiongs_tpu"),
                name=wb.get("name") or cfg.name, dir=cfg.trial_dir)
        except Exception as e:
            print(f"wandb logging disabled: {e}")
    return writer, wandb_run


def _eval_params(args, state):
    """Copy the EMA into the model's params for --use_ema (the state is not
    trained afterwards)."""
    import torch
    if args.use_ema and state.has_ema:
        ema = state.full_ema()
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(ema[k])


def _sample(system, batch, device, gen, return_trajectory=False):
    """system.sample from the first input view, through every input view's
    camera (launch.py:372-381)."""
    d = to_device({k: batch[k] for k in ("rgbs_input", "c2ws_input",
                                         "fxfycxcys_input")}, device)
    return system.sample(d["rgbs_input"][:, :1], d["c2ws_input"],
                         d["fxfycxcys_input"], generator=gen,
                         return_trajectory=return_trajectory)


def _scene_artifacts(out_dir, uid, out, bi, batch, renders, system,
                     device) -> None:
    """PLY + slerp path video of scene `bi` (systems/eval_utils.py)."""
    from .ops.gaussians import Gaussians, NumpyGaussians
    from .systems import eval_utils
    g = NumpyGaussians.from_tensors(
        Gaussians(*(x[bi] for x in out["gaussians"])))
    eval_utils.save_scene_gaussians(
        out_dir, uid, g, keyframe_c2ws=np.asarray(batch["c2ws_input"][bi]),
        fxfycxcy=np.asarray(batch["fxfycxcys_input"][bi]),
        h=renders.shape[-2], w=renders.shape[-1],
        raster_cfg=system.cfg.raster, device=device)


def validate(cfg, args, system, state, dataset, device, record):
    import torch

    from .data.loader import collate
    from .parallel.mesh import allreduce_metric_sums, eval_shard_indices
    from .utils.timing import StageClock
    from .systems import eval_utils
    from .utils.saving import chw_to_hwc, save_image_grid

    _eval_params(args, state)
    mesh = record["mesh"]
    # the ranks of a data row sample the same scenes; one writes them
    writes = mesh.leads_row
    step = state.step
    n_total = len(dataset)
    eval_bs = int(cfg.data.get("eval_batch_size", 1))
    save_videos = bool(getattr(system.cfg, "save_intermediate_video", False))
    # --test mirrors --validate but keeps its artifacts separate
    suffix = "-test" if args.test else ""
    out_dir = os.path.join(cfg.trial_dir, "save", f"it{step}{suffix}")
    if args.gradio and mesh.is_main:
        ProgressFile(os.path.join(cfg.trial_dir, "progress")).write(
            "Rendering video ..." if suffix else
            "Rendering validation image ...")
    owned = eval_shard_indices(n_total, mesh=mesh)
    # Lightning-parity trainer.limit_val_batches: int = batch count,
    # float in (0, 1) = fraction of the eval set
    lim = cfg.trainer.get("limit_val_batches") if cfg.trainer else None
    if lim is not None:
        n_batches = -(-len(owned) // eval_bs)
        keep = (max(1, int(round(n_batches * float(lim))))
                if 0 < float(lim) < 1 else int(lim))
        owned = owned[:keep * eval_bs]
    psnr_sum, view_count = 0.0, 0
    overflow: Dict[str, int] = {}
    clock = StageClock(record["seconds"], device)
    for i in range(0, len(owned), eval_bs):
        samples = [dataset[j] for j in owned[i:i + eval_bs]]
        batch = collate(samples)
        clock.stage("load")
        with torch.no_grad():
            out = _sample(system, batch, device,
                          generator(device, cfg.seed + 2, owned[i]),
                          return_trajectory=save_videos)
        renders = out["renders"].cpu().numpy()            # [b, v, 3, h, w]
        if save_videos:
            xt, x0 = (t.cpu().numpy() for t in out["trajectory"])
        for k in ("overflow_tiles", "overflow_gaussians", "binned_entries"):
            overflow[k] = overflow.get(k, 0) + int(out[k])
        clock.stage("sampler")
        # novel-view PSNR vs GT (summed; merged across processes below)
        gt = np.asarray(batch["rgbs_input"], np.float32)
        vv = min(renders.shape[1], gt.shape[1])
        if vv > 1:
            mse = ((np.clip(renders[:, 1:vv], 0, 1) - gt[:, 1:vv]) ** 2
                   ).reshape(renders.shape[0], vv - 1, -1).mean(-1)
            psnr_sum += float((-10.0 * np.log10(np.maximum(mse, 1e-10)))
                              .sum())
            view_count += mse.size
        for bi, uid in enumerate(batch["uid"] if writes else ()):
            if getattr(system.cfg, "save_result_for_eval", False):
                system.save_result_for_eval(
                    cfg.trial_dir, step, uid, renders[bi],
                    np.asarray(batch["rgbs_input"][bi]))
            save_image_grid(os.path.join(out_dir, f"{uid}.png"),
                            chw_to_hwc(renders[bi]))
            clock.stage("dumps")
            if save_videos:
                # x_t / pred_x0 trajectories + per-scene PLY + path video
                # (diffusion_gs_system_scene validation_step :203-219)
                tmap = np.asarray(system.sched_infer.timestep_map)[::-1]
                eval_utils.save_trajectory_videos(
                    out_dir, str(uid), xt[:, bi], x0[:, bi],
                    np.asarray(batch["rgbs_input"][bi, :1]), tmap)
                clock.stage("trajectory_videos")
                _scene_artifacts(out_dir, str(uid), out, bi, batch, renders,
                                 system, device)
                clock.stage("ply_and_path_video")
        if writes:
            print(f"validated {i + len(samples)}/{len(owned)} (of "
                  f"{n_total} total)", flush=True)

    total_psnr, total_views = allreduce_metric_sums([psnr_sum, view_count],
                                                    mesh)
    if total_views > 0 and mesh.is_main:
        summary = {"psnr": total_psnr / total_views,
                   "num_views": int(total_views), "step": step}
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "val_metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(f"val PSNR {summary['psnr']:.3f} dB over "
              f"{summary['num_views']} views", flush=True)
    record.update(out_dir=out_dir, scenes=len(owned), overflow=overflow)


def export(cfg, args, system, state, dataset, device, record):
    """Asset-export mode (reference launch.py:298,316-319: trainer.predict
    from a resumed ckpt; its predict_step is NotImplementedError in both
    reference systems, so this delivers the capability it advertises).

    Per owned scene: sample -> renders grid PNG, Gaussians PLY, and a
    slerp camera-path video through the scene's input poses."""
    import torch

    from .data.loader import collate
    from .parallel.mesh import eval_shard_indices
    from .utils.saving import chw_to_hwc, save_image_grid

    _eval_params(args, state)
    mesh = record["mesh"]
    writes = mesh.leads_row
    out_dir = os.path.join(cfg.trial_dir, "save", f"it{state.step}-export")
    progress = ProgressFile(os.path.join(cfg.trial_dir, "progress")
                            if args.gradio and mesh.is_main else None)
    progress.write("Exporting assets ...")
    owned = eval_shard_indices(len(dataset), mesh=mesh)
    lim = cfg.trainer.get("limit_val_batches") if cfg.trainer else None
    if lim is not None:
        keep = (max(1, int(round(len(owned) * float(lim))))
                if 0 < float(lim) < 1 else int(lim))
        owned = owned[:keep]
    for i, j in enumerate(owned):
        batch = collate([dataset[j]])
        with torch.no_grad():
            out = _sample(system, batch, device,
                          generator(device, cfg.seed + 3, j))
        if not writes:
            continue
        renders = out["renders"].cpu().numpy()            # [1, v, 3, h, w]
        uid = str(batch["uid"][0])
        save_image_grid(os.path.join(out_dir, f"{uid}.png"),
                        chw_to_hwc(renders[0]))
        _scene_artifacts(out_dir, uid, out, 0, batch, renders, system, device)
        print(f"exported {uid} ({i + 1}/{len(owned)}) -> {out_dir}",
              flush=True)
        progress.write(f"Exporting assets ... {i + 1}/{len(owned)}")
    if writes:
        print(f"export done: {len(owned)} scenes in {out_dir}", flush=True)
    record.update(out_dir=out_dir, scenes=len(owned))


class ProgressFile:
    """Single-line overwrite progress reporter (the reference's gradio
    ProgressCallback, utils/callbacks.py:144-179): an external UI polls the
    file for 'Generation progress: NN.NN%'-style lines."""

    def __init__(self, path):
        self.path = path
        self._fh = None

    def write(self, msg: str):
        if self.path is None:
            return
        if self._fh is None:
            self._fh = open(self.path, "w")
        self._fh.seek(0)
        self._fh.truncate()
        self._fh.write(msg)
        self._fh.flush()


def _snapshot_code(trial_dir: str):
    """Copy git-tracked sources into the trial dir (CodeSnapshot callback,
    utils/callbacks.py:83-117); nothing outside a git checkout."""
    import shutil
    import subprocess
    try:
        files = subprocess.run(
            ["git", "ls-files"], capture_output=True, text=True, cwd=ROOT,
            timeout=30).stdout.splitlines()
    except Exception:
        return
    dst_root = os.path.join(trial_dir, "code")
    for f in files:
        if not f.endswith((".py", ".yaml", ".cpp", ".md", "Makefile")):
            continue
        src = os.path.join(ROOT, f)
        dst = os.path.join(dst_root, f)
        if os.path.exists(src):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            try:
                shutil.copy2(src, dst)
            except OSError:
                pass


def _append_csv(path: str, step: int, metrics: Dict[str, float]):
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["step"] + sorted(metrics))
        w.writerow([step] + [metrics[k] for k in sorted(metrics)])


if __name__ == "__main__":
    if main()["mesh"].world > 1:      # in-process callers keep the group
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
