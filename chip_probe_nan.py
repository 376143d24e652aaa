"""Probes of the non-finite gradient that configs/diffusionGS_scene_512.yaml
gave now and then on an H100 at all 24 DiT layers (b = 12 from step 151,
LPIPS on: chip_smoke.py phase 20's step; ROADMAP Queue 3, Limits).

Its origin: a culled Gaussian whose depth in a rendered view was exactly
0 in f32.  The EWA Jacobian divided 0 by 0 there (ops/gs_math.py::
ewa_cov2d).  The loss stayed finite, but the backward of the conic
(`c * det_inv`, conic_and_radius) was 0 * NaN.  `catch` found it: its
caught step's replay fails again every time, its stats read one Gaussian
at view depth 0 with a NaN covariance, and anomaly detection names that
MulBackward0.  `trigger` builds the same case on purpose.  Every mode
prints `[probe ...]` lines; all but `depths` need one card and build the
kernels as chip_smoke.py's build does.

    python3 chip_probe_nan.py trigger       # 2 steps, one Gaussian moved to
                                            # view depth 0: FAIL (a NaN
                                            # norm) or pass
    python3 chip_probe_nan.py soak [N]      # N (60) steps, the norm read
                                            # after each: the non-finite
    python3 chip_probe_nan.py catch [N]     # up to N (30) steps, the state
                                            # snapshot before each; the first
                                            # non-finite step replayed: as
                                            # run, with stats, under anomaly
                                            # detection, with the blends' and
                                            # the attention's plain twins;
                                            # saved to build/probe_caught.pt
    python3 chip_probe_nan.py replay        # that saved step, run again
    python3 chip_probe_nan.py origin [N]    # N (4) steps: the non-finite
                                            # gradients before the clip,
                                            # flagged on the device and
                                            # read after the step
    python3 chip_probe_nan.py poison fill   # NaN in every torch.empty
    python3 chip_probe_nan.py poison cache  # NaN in every free cached block
    python3 chip_probe_nan.py depths [N]    # on the CPU: exact-0 view
                                            # depths of N (1200) batch
                                            # elements' pixel Gaussians at
                                            # random depths

PROBE_ROOT=<dir> runs the package of another checkout (an earlier commit
unpacked under build/) in place of this one's, for a comparison in one
call.
"""

import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RECIPE = "diffusionGS_scene_512.yaml"
SOAK_STEPS = 60     # at the 2-in-18 rate seen before the repair, 60 clean
                    # steps by luck have a chance of about 8e-4
CATCH_STEPS = 30


def _setup():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    # PROBE_ROOT: a checkout whose package the probe runs instead of this
    # one's (an earlier commit, unpacked under build/), compared in one call
    root = os.environ.get("PROBE_ROOT")
    if root:
        sys.path.insert(0, os.path.abspath(root))
    import open_diffusiongs_tpu_torch as port
    print(f"[probe] package {os.path.dirname(port.__file__)}", flush=True)
    from open_diffusiongs_tpu_torch.utils.config import load_config
    dev = port.require_cuda()
    cs.phase_device(torch)
    cs.phase_build()
    config = os.path.join(cs.ROOT, "configs", RECIPE)
    views = cs.recipe_views(load_config(config, makedirs=False))[1]
    return torch, cs, dev, config, views


def _keep_flags(torch, run):
    """Patch the train step's global norm so that every step keeps one
    finite flag per gradient on the device (no host sync inside the step);
    returns the list the flags land in, one (names, flags) per step."""
    import open_diffusiongs_tpu_torch.parallel.train_step as ts
    kept, norm = [], ts.global_norm

    def norm2(grads):
        names = {id(p.grad): n for n, p in run.params.items()
                 if p.grad is not None}
        kept.append(([names.get(id(g), "?") for g in grads],
                     torch.isfinite(torch.stack([g.float().sum()
                                                 for g in grads]))))
        return norm(grads)
    ts.global_norm = norm2
    return kept


def _bad(kept) -> list:
    """The names of the last step's non-finite gradients."""
    names, flags = kept[-1]
    return [names[i] for i in (~flags).nonzero().flatten().tolist()]


class _Snapshot:
    """The whole train state (params, Adam moments, EMA, the counters and
    the draws' generator) copied to pinned host memory before a step, and
    put back to replay that step."""

    def __init__(self, torch, run):
        opt = run.optimizer
        self.torch, self.run = torch, run
        self.dev = [*run.params.values(), *opt._mu.values(),
                    *opt._nu.values(), *run.state.ema_params.values()]
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in self.dev]

    def take(self):
        for h, d in zip(self.host, self.dev):
            h.copy_(d, non_blocking=True)
        self.count = self.run.optimizer.count
        self.step = self.run.state.step
        self.gen = self.run.gen.get_state()
        self.torch.cuda.synchronize()

    def restore(self):
        with self.torch.no_grad():
            for h, d in zip(self.host, self.dev):
                d.copy_(h, non_blocking=True)
        self.run.optimizer.count = self.count
        self.run.optimizer.mini_step = 0
        self.run.state.step = self.step
        self.run.gen.set_state(self.gen)
        self.torch.cuda.synchronize()


def _step(torch, run, kept):
    """One train step; (grad norm, non-finite gradients), read after it."""
    run.state, m = run.step(run.state, run.batch)
    norm = float(m["grad_norm"])
    return norm, ([] if math.isfinite(norm) else _bad(kept))


def _recipe(torch, cs, dev, config, views):
    run = cs.train_setup(torch, dev, config, cs.LPIPS_ON, views)
    return run, _keep_flags(torch, run)


def origin(n_steps: int):
    """n_steps of the recipe after one warm-up; which gradients were
    non-finite before the clip, from flags kept on the device and read
    after each step."""
    torch, cs, dev, config, views = _setup()
    run, kept = _recipe(torch, cs, dev, config, views)
    for i in range(n_steps + 1):
        norm, bad = _step(torch, run, kept)
        print(f"[probe origin] step {i} norm {norm}: {len(bad)} of "
              f"{len(kept[-1][0])} gradients non-finite {bad[:8]}",
              flush=True)
        if bad:
            break


def soak(n_steps: int):
    """n_steps of the recipe after one warm-up, nothing read inside a step;
    each step's global gradient norm read after it.  Stops at the first
    non-finite norm (the update has then spread it into every
    parameter)."""
    torch, cs, dev, config, views = _setup()
    run = cs.train_setup(torch, dev, config, cs.LPIPS_ON, views)
    t0, norms = time.perf_counter(), []
    for i in range(n_steps + 1):
        run.state, m = run.step(run.state, run.batch)
        norms.append(float(m["grad_norm"]))
        if not math.isfinite(norms[-1]):
            break
    secs = time.perf_counter() - t0
    bad = [i for i, n in enumerate(norms) if not math.isfinite(n)]
    out = dict(steps=len(norms) - 1, warm_up=1, non_finite=len(bad),
               first_non_finite=bad[0] if bad else None,
               seconds_per_step=secs / len(norms), norms=norms,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               card=cs.card_line())
    print(f"[probe soak] {json.dumps(out)}", flush=True)


def _poison_cache(torch, dev):
    """Fill every free byte the allocator can get with NaN, in blocks from
    4 GiB down to 512 KiB, and free them: the cached blocks the next step
    reuses then hold NaN wherever nobody writes."""
    held, size = [], 4 << 30
    while size >= 512 << 10:
        try:
            held.append(torch.full((size // 4,), float("nan"), device=dev))
        except torch.OutOfMemoryError:
            size //= 4
    n = sum(t.numel() * 4 for t in held)
    del held
    return n


def poison(how: str, n_steps: int = 3):
    """The recipe's step on memory that holds NaN wherever it is not
    written: `fill` (torch.empty's NaN fill under deterministic algorithms)
    or `cache` (`_poison_cache` before every step)."""
    import torch
    if how == "fill":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    torch, cs, dev, config, views = _setup()
    run, kept = _recipe(torch, cs, dev, config, views)
    for i in range(n_steps + 1):
        # the first step runs on clean memory: it makes the cuBLAS and
        # cuDNN handles, which the filled card would leave no room for
        poisoned = (_poison_cache(torch, dev) if how == "cache" and i
                    else None)
        norm, bad = _step(torch, run, kept)
        print(f"[probe poison {how}] step {i} norm {norm} poisoned bytes "
              f"{poisoned} non-finite {len(bad)}: {bad[:8]}", flush=True)
        if bad:
            break


def _stats_hooks(torch, notes):
    """Record, on the device, the extremes that could make a finite
    forward's backward non-finite: the renderer's view depths and
    conics, the points' distances and the LPIPS taps' norms."""
    from open_diffusiongs_tpu_torch.ops import gs_math, rasterize
    from open_diffusiongs_tpu_torch.systems import losses
    conic, pre, heads = (gs_math.conic_and_radius, rasterize.preprocess_view,
                         losses.lpips_heads)

    def conic2(cov2d):
        out = conic(cov2d)
        a, b, c = cov2d.detach().unbind(-1)
        det = a * c - b * b
        notes.append(("cov2d non-finite", (~torch.isfinite(cov2d)).sum()))
        notes.append(("det <= 0", (det <= 0).sum()))
        notes.append(("min |det|", det.abs().min()))
        notes.append(("conic non-finite",
                      (~torch.isfinite(out[0])).sum()))
        return out

    def pre2(act, cov3d, cam, h, w, sh_degree):
        out = pre(act, cov3d, cam, h, w, sh_degree)
        d = out.depth.detach()
        notes.append(("min |view depth|", d.abs().min()))
        notes.append(("view depth == 0", (d == 0).sum()))
        notes.append(("|view depth| < 1e-3", (d.abs() < 1e-3).sum()))
        notes.append(("xy non-finite", (~torch.isfinite(out.xy)).sum()))
        return out

    def heads2(params, fx, fy):
        for i, f in enumerate(fx):
            notes.append((f"lpips tap {i} min |f|^2",
                          (f.detach() * f.detach()).sum(1).min()))
        return heads(params, fx, fy)
    gs_math.conic_and_radius = conic2
    rasterize.preprocess_view = pre2
    losses.lpips_heads = heads2

    def undo():
        gs_math.conic_and_radius = conic
        rasterize.preprocess_view = pre
        losses.lpips_heads = heads
    return undo


def _summary(notes) -> dict:
    out = {}
    for k, v in notes:
        v = float(v)
        out[k] = (min(out.get(k, v), v) if k.startswith("min")
                  else out.get(k, 0.0) + v)
    return out


def _twin_blends(torch):
    """The blends' plain twins in place of #2 / #4 on CUDA tensors."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel as bk
    fwd, bwd = bk.blend_tiles, bk.blend_bwd
    bk.blend_tiles = lambda packed, idx, counts, tiles_x, return_end=False: \
        bk.blend_tiles_ref(packed, idx, counts, tiles_x, return_end)
    bk.blend_bwd = bk.blend_bwd_ref

    def undo():
        bk.blend_tiles, bk.blend_bwd = fwd, bwd
    return undo


def _twin_attention(torch):
    """The packed attention's plain twins in place of #1s / #3 on CUDA
    tensors, one (batch element, head) at a time."""
    from open_diffusiongs_tpu_torch.ops import attention as at
    fwd, bwd = at.flash_mha_packed, at._bwd_fused

    def fwd2(q, k, v, *, num_heads, l_real=None, with_stats=False, **kw):
        dh = q.shape[-1] // num_heads
        o, lse = torch.empty_like(q), q.new_empty(
            (q.shape[0], q.shape[1], num_heads), dtype=torch.float32)
        for bi in range(q.shape[0]):
            for h in range(num_heads):
                c = slice(h * dh, (h + 1) * dh)
                oh, lh = at.flash_mha_packed_ref(
                    q[bi:bi + 1, :, c], k[bi:bi + 1, :, c],
                    v[bi:bi + 1, :, c], num_heads=1, l_real=l_real,
                    with_stats=True)
                o[bi:bi + 1, :, c], lse[bi:bi + 1, :, h:h + 1] = oh, lh
        return (o, lse) if with_stats else o

    def bwd2(q, k, v, o, do, lse, num_heads, lq_real, lk_real,
             out_f32=False):
        b, lp, hd = q.shape
        dh = hd // num_heads
        out = q.new_empty((b, lp, 3 * hd))
        for bi in range(b):
            for h in range(num_heads):
                c = slice(h * dh, (h + 1) * dh)
                r = slice(bi, bi + 1)
                grads = at.flash_mha_packed_bwd_ref(
                    q[r, :, c], k[r, :, c], v[r, :, c], o[r, :, c],
                    do[r, :, c], lse[r, :, h:h + 1].contiguous(),
                    num_heads=1, lq_real=lq_real, lk_real=lk_real)
                for i, g in enumerate(grads):
                    out[r, :, i * hd + h * dh:i * hd + (h + 1) * dh] = g
        return out
    at.flash_mha_packed, at._bwd_fused = fwd2, bwd2

    def undo():
        at.flash_mha_packed, at._bwd_fused = fwd, bwd
    return undo


def _replay(torch, run, snap, kept, label, wrap=None, anomaly=False):
    """Put the snapshot back and run its step again (under `wrap`'s patches,
    or anomaly detection): the norm and the non-finite gradients."""
    import contextlib
    import warnings
    snap.restore()
    undo = wrap() if wrap else None
    caught = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with (torch.autograd.detect_anomaly(check_nan=True) if anomaly
                  else contextlib.nullcontext()):
                norm, bad = _step(torch, run, kept)
        result = dict(norm=norm, non_finite=len(bad), first=bad[:12])
    except (RuntimeError, torch.OutOfMemoryError) as e:
        result = dict(error=str(e)[:2000],
                      forward_trace=[str(w.message)[-4000:] for w in caught
                                     if "Traceback" in str(w.message)])
    finally:
        if undo:
            undo()
    print(f"[probe catch] replay {label}: {json.dumps(result)}", flush=True)
    return result


CAUGHT = os.path.join(HERE, "build", "probe_caught.pt")


def _save(torch, snap):
    """The snapshot of a caught step on disk (CAUGHT), for `replay`."""
    torch.save({"tensors": snap.host, "count": snap.count,
                "step": snap.step, "gen": snap.gen}, CAUGHT)
    print(f"[probe catch] saved {CAUGHT}", flush=True)


def replay():
    """The step that `catch` caught (CAUGHT) on a fresh set-up of the
    recipe: its state and draws loaded, the step run once as it ran and
    once with `_stats_hooks`."""
    torch, cs, dev, config, views = _setup()
    run, kept = _recipe(torch, cs, dev, config, views)
    _step(torch, run, kept)         # makes the Adam moments to load into
    snap = _Snapshot(torch, run)
    saved = torch.load(CAUGHT)
    snap.host = saved["tensors"]
    snap.count, snap.step, snap.gen = (saved["count"], saved["step"],
                                       saved["gen"])
    _replay(torch, run, snap, kept, "loaded")
    notes = []
    _replay(torch, run, snap, kept, "loaded with stats",
            wrap=lambda: _stats_hooks(torch, notes))
    print(f"[probe replay] stats {json.dumps(_summary(notes))}", flush=True)


def _zero_depth_point(torch, c2ws, fxfycxcys, view, h, w):
    """A point whose depth in view `view` of the cameras c2ws [V, 4, 4] is
    exactly 0 as the rasterizer computes it in f32 (its w2c from the
    same batched inverse): the camera's centre moved sideways, then along
    the view axis by the depth left, until none is left."""
    from open_diffusiongs_tpu_torch.ops import camera as cam_lib
    m = cam_lib.make_camera(c2ws, fxfycxcys, h, w).w2c[view]
    c2w = c2ws[view]
    g = torch.Generator(device=c2w.device).manual_seed(0)
    for _ in range(1000):
        p = c2w[:3, 3] + 0.5 * torch.randn(
            3, generator=g, device=c2w.device) * (c2w[:3, 0] + c2w[:3, 1])
        for _ in range(8):
            depth = m[2, 0] * p[0] + m[2, 1] * p[1] + m[2, 2] * p[2] + m[2, 3]
            if float(depth) == 0.0:
                return p
            p = p - depth * c2w[:3, 2]
    raise RuntimeError("no point at view depth 0 found")


def trigger():
    """The recipe's step with one Gaussian (batch element 0, row 0: a free
    Gaussian of the upsampler) moved to a view depth of exactly 0 in
    rendered view 1; its scaling and rotation keep their gradient path to
    the DiT.  Every step of it gives a non-finite gradient norm where
    the renderer has the fault, and a finite one where it is repaired."""
    torch, cs, dev, config, views = _setup()
    run, kept = _recipe(torch, cs, dev, config, views)
    point = _zero_depth_point(torch, run.batch["c2ws"][0],
                              run.batch["fxfycxcys"][0], 1, run.res, run.res)
    model, forward = run.system.model, run.system.model.forward

    def moved(*a, **kw):
        g, pix = forward(*a, **kw)
        xyz = g.xyz.clone()
        xyz[0, 0] = point
        return g._replace(xyz=xyz), pix
    model.forward = moved
    for i in range(2):
        norm, bad = _step(torch, run, kept)
        print(f"[probe trigger] step {i}: grad norm {norm}, {len(bad)} "
              f"gradients non-finite {bad[:6]}", flush=True)
    verdict = "FAIL" if bad or not math.isfinite(norm) else "pass"
    print(f"[probe trigger] {verdict} {cs.card_line()}", flush=True)


def catch(n_steps: int):
    """Up to n_steps of the recipe, each after a snapshot of the whole
    state; the first step whose norm is non-finite is replayed from its
    snapshot: as it ran, with the extremes of `_stats_hooks` read, under
    anomaly detection (the first backward node that gives NaN and the
    forward op that made it), with the blends' and then the attention's
    plain twins in place of the kernels, and as it ran again."""
    torch, cs, dev, config, views = _setup()
    run, kept = _recipe(torch, cs, dev, config, views)
    norm, bad = _step(torch, run, kept)                   # warm-up
    snap = _Snapshot(torch, run)
    for i in range(n_steps):
        snap.take()
        norm, bad = _step(torch, run, kept)
        print(f"[probe catch] step {i} norm {norm}", flush=True)
        if not bad and math.isfinite(norm):
            continue
        print(f"[probe catch] step {i}: {len(bad)} of {len(kept[-1][0])} "
              f"gradients non-finite: {bad[:16]} ... {bad[-8:]}", flush=True)
        try:
            _save(torch, snap)
        except (OSError, RuntimeError) as e:
            print(f"[probe catch] not saved: {e}", flush=True)
        _replay(torch, run, snap, kept, "as run")
        notes = []
        _replay(torch, run, snap, kept, "with stats",
                wrap=lambda: _stats_hooks(torch, notes))
        print(f"[probe catch] stats {json.dumps(_summary(notes))}",
              flush=True)
        _replay(torch, run, snap, kept, "anomaly", anomaly=True)
        _replay(torch, run, snap, kept, "blend twins",
                wrap=lambda: _twin_blends(torch))
        _replay(torch, run, snap, kept, "attention twins",
                wrap=lambda: _twin_attention(torch))
        _replay(torch, run, snap, kept, "as run again")
        return i
    print(f"[probe catch] {n_steps} steps, none non-finite", flush=True)
    return None


def depths(n_elements: int):
    """On the CPU: how often a scene step's pixel Gaussians land at a view
    depth of exactly 0.  Each of n_elements batch elements puts one point
    on every pixel ray of the 4 input views at 512², at depth
    sigmoid(N(0, 1)) * 500 (the scene denoiser's 'plk' head over
    range_setting_far 500), and forms its depth in each of the 7 rendered
    views as preprocess_view does.  The cameras are chip_smoke.py's
    train_batch's (the object template); the draws are a stand-in for the
    DiT's."""
    import numpy as np
    import torch

    from open_diffusiongs_tpu_torch.ops import camera as cam_lib
    from open_diffusiongs_tpu_torch.ops.rays import rays_chw
    from open_diffusiongs_tpu_torch.pipeline import object_camera_template
    res, views, n_in = 512, 7, 4
    c2ws, fxy = object_camera_template(views, h=res, w=res)
    c2w = torch.from_numpy(np.ascontiguousarray(c2ws, np.float32))
    fxy = torch.from_numpy(np.ascontiguousarray(fxy, np.float32))
    ray_o, ray_d = rays_chw(c2w[:n_in], fxy[:n_in], res, res)
    w2c = cam_lib.make_camera(c2w, fxy, res, res).w2c
    g = torch.Generator().manual_seed(1)
    zeros = 0
    for _ in range(n_elements):
        depth = torch.sigmoid(torch.randn((n_in, 1, res, res),
                                          generator=g)) * 500.0
        px, py, pz = (ray_o + depth * ray_d).movedim(1, -1).reshape(
            -1, 3).unbind(-1)
        for m in w2c:
            zeros += int((m[2, 0] * px + m[2, 1] * py + m[2, 2] * pz
                          + m[2, 3] == 0).sum())
    print(f"[probe depths] {n_elements} batch elements ({n_in} input views "
          f"at {res}², {views} rendered): {zeros} view depths exactly 0",
          flush=True)


MODES = {"trigger": (trigger, None), "soak": (soak, SOAK_STEPS),
         "catch": (catch, CATCH_STEPS), "replay": (replay, None),
         "origin": (origin, 4), "depths": (depths, 1200),
         "poison fill": (poison, 3),
         "poison cache": (poison, 3)}


def main(argv) -> int:
    args = [a for a in argv if not a.isdigit()]
    counts = [int(a) for a in argv if a.isdigit()]
    name = " ".join(args)
    if name not in MODES or len(counts) > 1 or (
            counts and MODES[name][1] is None):
        print(__doc__, file=sys.stderr)
        return 2
    fn, n = MODES[name]
    if name.startswith("poison"):
        fn(args[1], counts[0] if counts else n)
    elif n is None:
        fn()
    else:
        fn(counts[0] if counts else n)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
