"""Multi-process worlds for the port's parallel tests: gloo on the CPU, a
file:// rendezvous under the test's tmp_path, one spawned process per rank.

`run_world(target, world, tmp_path, *args)` runs `target(mesh_init, *args)`
on every rank, where `mesh_init(sp)` builds that rank's parallel/mesh.py
Mesh, and returns the ranks' return values (saved with torch.save), by
rank.  Targets live in this module (the children import it, not the test
module and its JAX imports).
"""

from __future__ import annotations

import functools
import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def run_world(target, world: int, tmp_path, *args, timeout: float = 900.0):
    """Every rank's return value; a rank that fails stops the others."""
    ctx = mp.get_context("spawn")
    os.makedirs(str(tmp_path), exist_ok=True)
    init = f"file://{os.path.join(str(tmp_path), 'rendezvous')}"
    procs = [ctx.Process(target=_entry, args=(target, rank, world, init,
                                              str(tmp_path), args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while (any(p.is_alive() for p in procs)
           and not any(p.exitcode for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = []
    for rank in range(world):
        err = os.path.join(str(tmp_path), f"error{rank}.txt")
        if os.path.exists(err):
            errors.append(open(err).read())
    if alive or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"world of {world} failed (timed out: "
                           f"{len(alive)}):\n" + "\n".join(errors))
    return [torch.load(os.path.join(str(tmp_path), f"out{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def _entry(target, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    try:
        from open_diffusiongs_tpu_torch.parallel.mesh import init_mesh
        mesh_init = functools.partial(
            init_mesh, device_type="cpu", backend="gloo", init_method=init,
            rank=rank, world_size=world, local_rank=rank, local_world=world)
        out = target(mesh_init, *args)
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _qkv_shard(q, k, v, lo, hi, requires_grad=False):
    qkv = torch.cat([torch.from_numpy(x[:, lo:hi]) for x in (q, k, v)], -1)
    return qkv.requires_grad_(requires_grad)


def ring_cases(mesh_init, inputs):
    """Every ring case of tests/test_torch_ring.py on one world of 4."""
    from open_diffusiongs_tpu_torch.parallel.ring import ring_attention
    out = {}
    # sp = 4: forward, pad keys spanning two shards (one all padding)
    mesh = mesh_init(seq_parallel=4)
    q, k, v, h, l_real = inputs["fwd"]
    lq = q.shape[1] // 4
    lo = mesh.seq_rank * lq
    with torch.no_grad():
        out["fwd"] = ring_attention(_qkv_shard(q, k, v, lo, lo + lq),
                                    num_heads=h, l_real=l_real, mesh=mesh)
    # sp = 4: gradients of sum(out[:, :l_real]^2)
    q, k, v, h, l_real = inputs["grad"]
    qkv = _qkv_shard(q, k, v, lo, lo + lq, requires_grad=True)
    o = ring_attention(qkv, num_heads=h, l_real=l_real, mesh=mesh)
    real = max(0, min(lq, l_real - lo))
    (o[:, :real] ** 2).sum().backward()
    out["grad"] = qkv.grad
    # dp = 2 x sp = 2: batch element d on data row d
    mesh = mesh_init(seq_parallel=2)
    q, k, v, h, l_real = inputs["dp2"]
    d, lq = mesh.data_rank, q.shape[1] // 2
    lo = mesh.seq_rank * lq
    qkv = _qkv_shard(*(x[d:d + 1] for x in (q, k, v)), lo, lo + lq,
                     requires_grad=True)
    o = ring_attention(qkv, num_heads=h, l_real=l_real, mesh=mesh)
    real = max(0, min(lq, l_real - lo))
    (o[:, :real] ** 2).sum().backward()
    out["dp2"] = (o.detach(), qkv.grad)
    out["stack"] = _module_case(mesh, inputs["stack"], "stack")
    out["qk_norm"] = _module_case(mesh, inputs["qk_norm"], "qk_norm")
    out["denoiser"] = _denoiser_case(mesh, inputs["denoiser"])
    return out


def _module_case(mesh, case, kind):
    """A DiTStack (or a qk_norm DiTBlock, padded and sharded here as the
    stack does) on data row d's sample: output and the parameters'
    gradients of sum(out * r)."""
    from open_diffusiongs_tpu_torch.models import transformer as ttr
    from open_diffusiongs_tpu_torch.ops.attention import plan_packed
    d = mesh.data_rank
    x = torch.from_numpy(case["x"][d:d + 1]).requires_grad_()
    c = torch.from_numpy(case["c"][d:d + 1])
    r = torch.from_numpy(case["r"][d:d + 1])
    width, heads = case["width"], case["heads"]
    if kind == "stack":
        mod = ttr.DiTStack(width, heads, case["layers"], checkpoint=True,
                           seq=mesh)
        mod.load_state_dict(case["sd"], strict=True)
        assert all(b.attn.packed for b in mod)
        y = mod(x, c)
    else:
        mod = ttr.DiTBlock(width, heads, qk_norm=True, seq=mesh)
        mod.load_state_dict(case["sd"], strict=True)
        assert not mod.attn.packed
        from open_diffusiongs_tpu_torch.parallel.ring import gather_seq
        l = x.shape[1]
        lq = plan_packed(l)[0] // mesh.sp
        lo = mesh.seq_rank * lq
        xs = torch.nn.functional.pad(x, (0, 0, 0, lq * mesh.sp - l))
        y = gather_seq(mod(xs[:, lo:lo + lq], c, l), mesh)[:, :l]
    (y * r).sum().backward()
    grads = {n: p.grad for n, p in mod.named_parameters()}
    return y.detach(), x.grad, grads


def _denoiser_case(mesh, case):
    from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
    d = mesh.data_rank
    model = DGSDenoiser(**case["kw"], seq=mesh)
    model.load_state_dict(case["sd"], strict=True)
    args = [torch.from_numpy(np.asarray(a)[d:d + 1]) for a in case["inputs"]]
    with torch.no_grad():
        g, _ = model(*args)
    return g.xyz, g.opacity


def build_tiny_system(case, mesh=None):
    """The object system of `case["system"]` (a config `system` block) on
    the CPU, in f32, initialized from seed 0."""
    from open_diffusiongs_tpu_torch import _register_builtins
    from open_diffusiongs_tpu_torch.systems.builder import build_system
    _register_builtins()
    system = build_system("diffusion-gs-system", case["system"], bf16=False,
                          device="cpu", mesh=mesh)
    system.init_params(torch.Generator().manual_seed(0))
    return system


def train_steps(case, mesh, steps, rows, zero1=False, resume=None,
                save=None):
    """`steps` train steps of the tiny system on batch rows `rows` (this
    data rank's), the step's draws from seed 100 + step; optionally
    restored from / saved to a checkpoint directory first / last.  Returns
    each step's metrics, the whole state (ZeRO-1 shards gathered, tensor-
    and pipeline-parallel parts put together) and the last step's raw
    gradients, whole."""
    from open_diffusiongs_tpu_torch.parallel import train_step as ts
    from open_diffusiongs_tpu_torch.parallel.shard import gather_state_dict
    from open_diffusiongs_tpu_torch.utils.checkpoint import \
        CheckpointManager
    system = build_tiny_system(case, mesh)
    params = dict(system.model.named_parameters())
    opt = ts.make_optimizer(ts.OptimizerConfig(**case["opt"]),
                            params.items(), mesh=mesh, zero1=zero1)
    state = ts.init_train_state(params, opt, ema_decay=0.9)
    if resume:
        CheckpointManager(resume, mesh=mesh).restore(state)
    step_fn = ts.make_train_step(
        lambda b, s: system.train_loss(
            b, s, generator=torch.Generator().manual_seed(100 + s)),
        opt, ema_decay=0.9)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
             for k, v in case["batch"].items()}
    # each step's raw gradients, before the optimizer clips them in place
    grads = {}
    for k, p in params.items():
        p.register_post_accumulate_grad_hook(
            lambda p, k=k: grads.__setitem__(k, p.grad.detach().clone()))
    metrics = []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    if save:
        CheckpointManager(save, mesh=mesh).maybe_save(state, force=True)

    def whole(d):
        return {k: v.detach().clone()
                for k, v in gather_state_dict(d, mesh).items()}
    sd = opt.state_dict()
    return dict(metrics=metrics, params=whole(state.params),
                ema=whole(state.full_ema()), mu=whole(sd["mu"]),
                nu=whole(sd["nu"]), count=sd["count"], grads=whole(grads),
                zero1=type(opt).__name__ == "Zero1Optimizer",
                shard=[t.clone() for t in (state.ema_shard or [])])


def parallel_cases(mesh_init, inputs):
    """Every case of tests/test_torch_parallel.py on one world of 2."""
    out = {}
    mesh = mesh_init(seq_parallel=1)                 # dp = 2
    rows = slice(mesh.data_rank, mesh.data_rank + 1)
    out["ddp"] = train_steps(inputs["case"], mesh, 2, rows)
    out["zero1"] = train_steps(inputs["case"], mesh, 2, rows, zero1=True,
                               save=inputs["save_dir"])
    out["resume"] = train_steps(inputs["case"], mesh, 0, rows, zero1=True,
                                resume=inputs["one_dir"])
    mesh = mesh_init(seq_parallel=2)                 # dp = 1, sp = 2
    out["sp2"] = train_steps(inputs["sp_case"], mesh, 1, slice(0, 2))
    out["launch"] = _launch_train(mesh.rank, inputs["launch"])
    out["launch_tp"] = _launch_train(mesh.rank, inputs["launch_tp"])
    return out


def _launch_train(rank, argv):
    """Two-process `launch --train` (the default group is already up);
    rank 1 records every file it would write."""
    import builtins

    from open_diffusiongs_tpu_torch import launch
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2")
    launch._loggers = lambda cfg: (None, None)
    writes = []
    if rank == 1:
        real_open, real_save = builtins.open, torch.save
        real_makedirs, real_replace = os.makedirs, os.replace

        def rec_open(path, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                writes.append(str(path))
            return real_open(path, mode, *a, **k)

        def rec(fn):
            def wrapped(path, *a, **k):
                writes.append(str(path))
                return fn(path, *a, **k)
            return wrapped
        builtins.open, os.makedirs = rec_open, rec(real_makedirs)
        os.replace = rec(real_replace)
        torch.save = lambda obj, f, *a, **k: (writes.append(str(f)),
                                             real_save(obj, f, *a, **k))
    try:
        record = launch.main(argv)
    finally:
        if rank == 1:
            builtins.open, torch.save = real_open, real_save
            os.makedirs, os.replace = real_makedirs, real_replace
    from open_diffusiongs_tpu_torch.parallel.shard import gather_state_dict
    state, mesh = record["state"], record["mesh"]

    def whole(d):
        return {k: v.detach().clone()
                for k, v in gather_state_dict(d, mesh).items()}
    return dict(writes=writes, trial_dir=record["trial_dir"],
                step=state.step, params=whole(state.params),
                ema=whole(state.full_ema()),
                mu=whole(state.optimizer.state_dict()["mu"]))


def _shard_heads(x, tp, m):
    """Model rank m's heads (a contiguous column block) of [b, l, h·dh]."""
    w = x.shape[-1] // tp
    return x[..., m * w:(m + 1) * w]


def _stack_case(case, mesh, rows, **kw):
    """The port's DiTStack of `case` (a qk_norm DiTBlock where the case
    says so; its whole state dict cut to this rank's part) on batch rows
    `rows`: output, the input's gradient and every parameter's gradient,
    whole, of sum(out * r)."""
    from open_diffusiongs_tpu_torch.models import transformer as ttr
    from open_diffusiongs_tpu_torch.parallel.shard import (
        gather_state_dict, shard_for_mesh)
    x = torch.from_numpy(case["x"][rows]).requires_grad_()
    c = torch.from_numpy(case["c"][rows])
    r = torch.from_numpy(case["r"][rows])
    if case.get("qk_norm"):
        mod = ttr.DiTBlock(case["width"], case["heads"], qk_norm=True, **kw)
        blocks = [mod]
    else:
        mod = blocks = ttr.DiTStack(case["width"], case["heads"],
                                    case["layers"], checkpoint=True, **kw)
    mod.load_state_dict(shard_for_mesh(case["sd"], mesh, stack=""),
                        strict=True)
    y = mod(x, c)
    (y * r).sum().backward()
    grads = gather_state_dict({n: p.grad for n, p in mod.named_parameters()},
                              mesh, stack="")
    return dict(y=y.detach(), gx=x.grad, grads=grads,
                packed=[b.attn.packed for b in blocks])


def _quant_case(case, mesh, rows):
    """The W8A8 stack on rows `rows`, tensor-parallel over `mesh` and on
    one rank, under no_grad."""
    from open_diffusiongs_tpu_torch.models import transformer as ttr
    from open_diffusiongs_tpu_torch.parallel.shard import shard_for_mesh
    x = torch.from_numpy(case["x"][rows])
    c = torch.from_numpy(case["c"][rows])
    out = {}
    for key, m in (("tp", mesh), ("one", None)):
        mod = ttr.DiTStack(case["width"], case["heads"], case["layers"],
                           quant_int8=True, attn_impl="xla", model=m)
        mod.load_state_dict(shard_for_mesh(case["sd"], m, stack=""),
                            strict=True)
        with torch.no_grad():
            out[key] = mod(x, c)
    return out


def _ring_tp_case(mesh, case):
    """Ring attention on the local heads: rank (s, m) holds rows s and
    heads m of q, k, v; output and gradient of its part of
    sum(out[:, :l_real]^2)."""
    from open_diffusiongs_tpu_torch.parallel.ring import ring_attention
    q, k, v, h, l_real = case
    s, m, tp = mesh.seq_rank, mesh.model_rank, mesh.tp
    lq = q.shape[1] // mesh.sp
    qkv = torch.cat([_shard_heads(torch.from_numpy(a[:, s * lq:(s + 1) * lq]),
                                  tp, m) for a in (q, k, v)], -1)
    qkv.requires_grad_()
    o = ring_attention(qkv, num_heads=h // tp, l_real=l_real, mesh=mesh)
    real = max(0, min(lq, l_real - s * lq))
    (o[:, :real] ** 2).sum().backward()
    return o.detach(), qkv.grad


def tensor_parallel_cases(mesh_init, inputs):
    """Every case of tests/test_torch_tensor_parallel.py on one world of 4."""
    from open_diffusiongs_tpu_torch.parallel import tensor_parallel
    out = {}
    mesh = mesh_init(seq_parallel=1, model_parallel=2)     # dp = 2, tp = 2
    rows = slice(mesh.data_rank, mesh.data_rank + 1)
    tensor_parallel.BYTES = 0
    out["stack"] = _stack_case(inputs["stack"], mesh, rows, model=mesh)
    out["stack_bytes"] = tensor_parallel.BYTES
    out["general"] = _stack_case(inputs["general"], mesh, rows, model=mesh)
    out["qk_norm"] = _stack_case(inputs["qk_norm"], mesh, rows, model=mesh)
    out["quant"] = _quant_case(inputs["quant"], mesh, rows)
    case = inputs["case"]
    out["step"] = train_steps(case, mesh, 1, rows)
    out["ddp"] = train_steps(case, mesh, 2, rows)
    out["zero1"] = train_steps(case, mesh, 2, rows, zero1=True,
                               save=inputs["save_dir"])
    out["resume"] = train_steps(case, mesh, 0, rows, zero1=True,
                                resume=inputs["one_dir"])
    mesh = mesh_init(seq_parallel=2, model_parallel=2)     # sp = 2, tp = 2
    out["ring"] = _ring_tp_case(mesh, inputs["ring"])
    return out


def _toy_case(mesh, case, n_microbatches):
    """JAX's toy stage (tanh(h @ W + c) per layer) through pipeline_apply:
    output, and the gradients of sum(out^2) for this stage's W, x and c."""
    from open_diffusiongs_tpu_torch.parallel.pipeline import pipeline_apply
    params, x, c = (torch.from_numpy(a) for a in case)
    per = params.shape[0] // mesh.pp
    w = params[mesh.pipe_rank * per:(mesh.pipe_rank + 1) * per]
    w = w.clone().requires_grad_()
    x = x.clone().requires_grad_()
    c = c.clone().requires_grad_()

    def stage(h, c_mb):
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i] + c_mb)
        return h
    y = pipeline_apply(mesh, stage, x, c, n_microbatches, params=[w])
    (y ** 2).sum().backward()
    return y.detach(), w.grad, x.grad, c.grad


def _serve_case(mesh, case):
    """`DiffusionGSPipeline.batch` of the tiny system over `mesh`'s data
    ranks: each element's renders and Gaussian centres."""
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    pipe = DiffusionGSPipeline(build_tiny_system(case, mesh))
    outs = pipe.batch(case["images"], mesh=mesh, **case["kw"])
    return [(o.renders, o.gaussians.xyz) for o in outs]


def pipeline_parallel_cases(mesh_init, inputs):
    """Every case of tests/test_torch_pipeline_parallel.py on one world of
    2."""
    out = {}
    mesh = mesh_init(pipe_parallel=2)                       # pp = 2
    out["toy"] = {mb: _toy_case(mesh, inputs["toy"], mb) for mb in (1, 2)}
    out["stack"] = _stack_case(inputs["stack"], mesh, slice(0, 2),
                               pipe=mesh)
    case = inputs["case"]
    out["train"] = train_steps(case, mesh, 1, slice(0, 2))
    out["resume"] = train_steps(case, mesh, 0, slice(0, 2),
                                resume=inputs["one_dir"])
    mesh = mesh_init(seq_parallel=1)                        # dp = 2
    out["serve"] = _serve_case(mesh, inputs["serve"])
    return out
