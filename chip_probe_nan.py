"""Probes of the non-finite gradient that configs/diffusionGS_scene_512.yaml
shows now and then on an H100 at all 24 DiT layers (b = 12 from step 151,
LPIPS on: chip_smoke.py phase 20's step; ROADMAP Queue 3).  Each mode
prints `[probe ...]` lines; every mode needs one card and the kernels
built by chip_smoke.py's build.

    python3 chip_probe_nan.py repeat       # phase 20's step, 3 runs (2, 3,
                                           # 2 timed steps): which finish
    python3 chip_probe_nan.py trace        # 3 runs of 6 steps with the
                                           # extremes of every attention /
                                           # blend backward's tensors and of
                                           # every gradient, read after the
                                           # step: the first non-finite one
    python3 chip_probe_nan.py inputs       # 3 runs of 6 steps: zero
                                           # points-distance norms, zero
                                           # LPIPS feature vectors
    python3 chip_probe_nan.py repeatable   # #1s, #3 and #4 at this recipe's
                                           # shapes, repeated bit for bit
    python3 chip_probe_nan.py origin       # 4 runs: which gradients are
                                           # non-finite before the clip
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
RECIPE = "diffusionGS_scene_512.yaml"


def _setup():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    import open_diffusiongs_tpu_torch as port
    from open_diffusiongs_tpu_torch.utils.config import load_config
    dev = port.require_cuda()
    cs.phase_device(torch)
    cs.phase_build()
    config = os.path.join(cs.ROOT, "configs", RECIPE)
    views = cs.recipe_views(load_config(config, makedirs=False))[1]
    return torch, cs, dev, config, views


def _runs(torch, cs, dev, config, views, steps_list, label):
    for run, steps in enumerate(steps_list):
        try:
            cs.phase_train(torch, dev, f"probe {label} run {run}", config,
                           overrides=cs.LPIPS_ON, sup_views=views,
                           steps=steps, after=lambda system, batch: {})
            print(f"[probe {label}] run {run} ok", flush=True)
        except AssertionError as e:
            print(f"[probe {label}] run {run} FAIL {e}", flush=True)
        torch.cuda.empty_cache()


def _extremes(torch, t):
    return torch.stack([t.amax().float(), t.amin().float()])


def _watch_backwards(torch, notes):
    """Record the extremes of the packed attention's and the blend's
    backward tensors (device side, no host sync)."""
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel

    def keep(what, **ts):
        notes.extend((f"{what} {k}", _extremes(torch, t))
                     for k, t in ts.items() if t is not None)
    attn, blend, rows = (attention._bwd_fused, blend_kernel.blend_bwd,
                         blend_kernel.candidate_grads_to_rows)

    def attn2(q, k, v, o, do, lse, *a, **kw):
        keep("attn in", do=do, q=q, k=k, v=v, o=o, lse=lse)
        out = attn(q, k, v, o, do, lse, *a, **kw)
        keep("attn out", dqkv=out)
        return out

    def blend2(packed, idx, counts, t_fin, acc_c, acc_d, d_tfin, d_accc,
               d_accd, *a, **kw):
        keep("blend in", d_tfin=d_tfin, d_accc=d_accc, d_accd=d_accd,
             packed=packed, t_fin=t_fin, acc_c=acc_c, acc_d=acc_d)
        dg = blend(packed, idx, counts, t_fin, acc_c, acc_d, d_tfin, d_accc,
                   d_accd, *a, **kw)
        keep("blend dg", dg=dg)
        return dg

    def rows2(dg, gidx):
        out = rows(dg, gidx)
        keep("blend rows", rows=out)
        return out
    attention._bwd_fused = attn2
    blend_kernel.blend_bwd = blend2
    blend_kernel.candidate_grads_to_rows = rows2
    return keep


def _after_each_step(fn):
    """Run fn() after every train step phase_train builds."""
    import open_diffusiongs_tpu_torch.parallel.train_step as ts
    make = ts.make_train_step

    def make2(loss_fn, optimizer, **kw):
        step = make(loss_fn, optimizer, **kw)

        def step2(state, batch):
            out = step(state, batch)
            fn()
            return out
        return step2
    ts.make_train_step = make2


def trace():
    torch, cs, dev, config, views = _setup()
    import open_diffusiongs_tpu_torch.systems.builder as bl
    notes, n = [], [0]
    keep = _watch_backwards(torch, notes)
    build = bl.build_system

    def build2(*a, **k):
        system = build(*a, **k)
        for name, p in system.model.named_parameters():
            p.register_hook(lambda g, name=name: keep(f"grad {name}", g=g))
        return system
    bl.build_system = build2

    def scan():
        n[0] += 1
        torch.cuda.synchronize()
        bad = [lbl for lbl, v in notes if not bool(torch.isfinite(v).all())]
        if bad:
            print(f"[probe trace] step {n[0]}: {len(bad)} of {len(notes)} "
                  f"non-finite, first {bad[:10]}", flush=True)
        notes.clear()
    _after_each_step(scan)
    _runs(torch, cs, dev, config, views, (6, 6, 6), "trace")
    print(f"[probe trace] {n[0]} steps", flush=True)


def inputs():
    torch, cs, dev, config, views = _setup()
    from open_diffusiongs_tpu_torch.systems import losses
    stats, n = [], [0]
    compute, heads = losses.compute_losses, losses.lpips_heads

    def compute2(rendering, target, ray_o, img_aligned_xyz=None, *a, **k):
        if img_aligned_xyz is not None:
            with torch.no_grad():
                d = torch.linalg.norm(img_aligned_xyz - ray_o, dim=2)
                stats.extend([("dist==0", (d == 0).sum()),
                              ("dist<1e-6", (d < 1e-6).sum()),
                              ("min dist", d.min())])
        return compute(rendering, target, ray_o, img_aligned_xyz, *a, **k)

    def heads2(params, fx, fy):
        with torch.no_grad():
            stats.extend((f"lpips norm==0 tap {i}", ((f * f).sum(1) == 0)
                          .sum()) for i, f in enumerate(fx) if f.requires_grad)
        return heads(params, fx, fy)
    losses.compute_losses, losses.lpips_heads = compute2, heads2

    def scan():
        n[0] += 1
        torch.cuda.synchronize()
        st = {}
        for lbl, v in stats:
            st.setdefault(lbl, []).append(float(v))
        stats.clear()
        print(f"[probe inputs] step {n[0]} "
              f"{ {k: min(v) if k == 'min dist' else sum(v) for k, v in st.items()} }",
              flush=True)
    _after_each_step(scan)
    _runs(torch, cs, dev, config, views, (6, 6, 6), "inputs")


def repeatable():
    torch, cs, dev, config, views = _setup()
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel

    def same(name, fn, reps):
        ref = [x.clone() for x in fn()]
        differ = nonfinite = 0
        for _ in range(reps):
            out = fn()
            differ += not all(torch.equal(a, b) for a, b in zip(ref, out))
            nonfinite += not all(bool(torch.isfinite(b).all()) for b in out
                                 if b.is_floating_point())
        print(f"[probe repeatable] {name}: {reps} repeats, {differ} differ, "
              f"{nonfinite} non-finite", flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    b, l, h, dh = 12, 16386, 16, 64      # the recipe's DiT attention
    qkv = (torch.randn((b, l, 3 * h * dh), generator=g, device=dev) * 2
           ).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    do = (torch.randn((b, l, h * dh), generator=g, device=dev) * 1e-3
          ).to(torch.bfloat16)
    same("#1s", lambda: attention.flash_mha_packed(
        q, k, v, num_heads=h, l_real=l, with_stats=True), 10)
    o, lse = attention.flash_mha_packed(q, k, v, num_heads=h, l_real=l,
                                        with_stats=True)
    same("#3", lambda: [attention._bwd_fused(q, k, v, o, do, lse, h, l, l)],
         25)
    del qkv, q, k, v, do, o, lse
    torch.cuda.empty_cache()
    # #4 on the inputs of a step of this recipe at b = 2
    stash, blend = {}, blend_kernel.blend_bwd

    def grab(*a, **kw):
        stash.setdefault("args", ([x.clone() if torch.is_tensor(x) else x
                                   for x in a], kw))
        return blend(*a, **kw)
    blend_kernel.blend_bwd = grab
    cs.phase_train(torch, dev, "probe repeatable b=2", config,
                   overrides=cs.LPIPS_ON + ("data.batch_size=2",),
                   sup_views=views, profile=False, steps=1)
    blend_kernel.blend_bwd = blend
    a, kw = stash["args"]
    same("#4", lambda: [blend(*a, **kw)], 25)


def origin():
    torch, cs, dev, config, views = _setup()
    import open_diffusiongs_tpu_torch.parallel.train_step as ts
    import open_diffusiongs_tpu_torch.systems.builder as bl
    systems, norm, build = [], ts.global_norm, bl.build_system

    def build2(*a, **k):
        systems.append(build(*a, **k))
        return systems[-1]

    def norm2(grads):
        names = {id(p.grad): n for n, p in
                 systems[-1].model.named_parameters() if p.grad is not None}
        sums = torch.stack([g.float().sum() for g in grads])
        bad = [names.get(id(grads[i]), "?") for i in
               (~torch.isfinite(sums)).nonzero().flatten().tolist()]
        if bad:
            print(f"[probe origin] {len(bad)} of {len(grads)} gradients "
                  f"non-finite: {bad[:12]} ... {bad[-12:]}", flush=True)
        return norm(grads)
    bl.build_system, ts.global_norm = build2, norm2
    _runs(torch, cs, dev, config, views, (2, 2, 2, 2), "origin")


def main(argv) -> int:
    modes = {"repeat": None, "trace": trace, "inputs": inputs,
             "repeatable": repeatable, "origin": origin}
    if len(argv) != 1 or argv[0] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "repeat":
        torch, cs, dev, config, views = _setup()
        _runs(torch, cs, dev, config, views, (2, 3, 2), "repeat")
    else:
        modes[argv[0]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
