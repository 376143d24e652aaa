#!/usr/bin/env python3
"""Drive the PyTorch port's object-sampling path once on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one summary line each (every failure raises and exits non-zero):
  1. device    card name / power limit (nvidia-smi), torch, CUDA, nvcc and
               triton versions;
  2. build     nvcc builds both kernels from open_diffusiongs_tpu_torch/csrc;
  3. attention the flash-attention kernel against flash_mha_packed_ref on
               bf16 inputs at the 256^2 DiT shape (L = 4098, 16 heads of 64)
               and on a ragged layout (Lp > l_real, garbage pad rows);
  4. blend     the tile-blend kernel against blend_tiles_ref on one real
               256^2 view (random-init denoiser Gaussians, binned by the
               port);
  5. main path configs/diffusionGS_rel.yaml (width 1024, 24 layers, 30
               steps, 4 views) with random weights from seed 0, through
               DiffusionGSPipeline.batch on extra_files/test_cases/sphere.png
               at 256^2, twice; the second run is timed and its kernel
               launches counted.
Then the kernels' JSON line, the card line, and the result line
{"ok": true, "device": {...}}.  Imports nothing of JAX.  Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "diffusionGS_rel.yaml")
IMAGE = os.path.join(ROOT, "extra_files", "test_cases", "sphere.png")

ATTN_REL_BOUND = 8e-3    # max|err| / max|ref| in bf16 (the TPU kernel's bar)
BLEND_ABS_BOUND = 2e-5   # the rasterizer's forward parity bar (atol)
RES = 256
N_VIEWS = 4
STEPS = 30


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> dict:
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True)
    nvcc_ver = (nvcc.stdout.strip().splitlines() or ["?"])[-1] \
        if nvcc.returncode == 0 else "nvcc not on PATH"
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not installed"
    info = {"card": card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc_ver,
            "triton": triton_ver}
    print(f"[1 device] {json.dumps(info)}", flush=True)
    return info


def phase_build() -> float:
    from open_diffusiongs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    secs = time.perf_counter() - t0
    nvcc = ("cached build reused" if _build.BUILD_SECONDS is None
            else f"nvcc {_build.BUILD_SECONDS:.2f} s")
    print(f"[2 build] kernels ready in {secs:.2f} s ({nvcc}) -> "
          f"{_build.build_dir()}", flush=True)
    return secs


def attention_case(torch, dev, gen, b, l_real, lp, h, dh, fused: bool):
    """Kernel vs plain version on bf16 inputs; rows >= l_real hold 1e4."""
    from open_diffusiongs_tpu_torch.ops import attention
    hd = h * dh
    qkv = torch.randn((b, lp, 3 * hd), generator=gen, device=dev,
                      dtype=torch.float32).to(torch.bfloat16)
    qkv[:, l_real:] = 1e4                       # garbage pad rows
    if fused:       # column slices of one qkv projection, as in the DiT
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        q, k, v = (x.contiguous() for x in qkv.chunk(3, dim=-1))
    kw = dict(num_heads=h, l_real=l_real)
    out = attention.flash_mha_packed(q, k, v, **kw)
    ref = attention.flash_mha_packed_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    o, r = out[:, :l_real].float(), ref[:, :l_real].float()
    if not torch.isfinite(o).all():
        raise AssertionError("attention kernel: non-finite real rows")
    err = float((o - r).abs().max())
    rel = err / float(r.abs().max())
    return err, rel, (q, k, v), kw


def phase_attention(torch, dev) -> dict:
    import torch.nn.functional as F

    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(0)
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    err, rel, (q, k, v), kw = attention_case(torch, dev, gen, 1, l, l, 16,
                                             64, fused=True)
    err_r, rel_r, _, _ = attention_case(torch, dev, gen, 1, l, 4608, 16, 64,
                                        fused=False)
    ms = cuda_ms(lambda: attention.flash_mha_packed(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: attention.flash_mha_packed_ref(q, k, v, **kw),
                       3)
    q4, k4, v4 = (x.reshape(1, l, 16, 64).transpose(1, 2) for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
    res = {"max_abs_err": err, "rel_max_err": rel,
           "ragged_max_abs_err": err_r, "ragged_rel_max_err": rel_r,
           "ms": ms, "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
           "shape": f"b=1 L={l} h=16 dh=64 bf16"}
    print(f"[3 attention] {json.dumps(res)}", flush=True)
    for name, r in (("L=4098", rel), ("ragged Lp=4608", rel_r)):
        if not r <= ATTN_REL_BOUND:
            raise AssertionError(f"attention kernel {name}: rel-max error "
                                 f"{r:.3g} > {ATTN_REL_BOUND}")
    return res


def build_system(torch, dev):
    from open_diffusiongs_tpu_torch.systems.builder import (build_system,
                                                            load_config)
    cfg = load_config(CONFIG)
    system = build_system(cfg["system_type"], cfg["system"], device=dev)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    return system


def phase_blend(torch, dev, system) -> dict:
    """One 256^2 view of a random-init denoiser's Gaussians (t = T-1 step,
    view 1), preprocessed and binned by the port."""
    from PIL import Image

    from open_diffusiongs_tpu_torch.ops import blend_kernel, gs_math
    from open_diffusiongs_tpu_torch.ops import camera as cam_lib
    from open_diffusiongs_tpu_torch.ops import rasterize as rz
    from open_diffusiongs_tpu_torch.ops.rays import rays_chw
    from open_diffusiongs_tpu_torch.pipeline import (object_camera_template,
                                                     preprocess_image)
    cond = preprocess_image(Image.open(IMAGE), 0.85, RES, matting="border")
    c2ws, fxy = object_camera_template(N_VIEWS, h=RES, w=RES)
    c2w = torch.from_numpy(c2ws).to(dev)[None]
    fxy_t = torch.from_numpy(fxy).to(dev)[None]
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.cat([torch.from_numpy(cond).to(dev)[None, None],
                        torch.randn((1, N_VIEWS - 1, 3, RES, RES),
                                    generator=gen, device=dev)], 1)
    ray_o, ray_d = rays_chw(c2w, fxy_t, RES, RES)
    t = torch.as_tensor(system.sched_infer.timestep_map[-1:], device=dev)
    with torch.no_grad():
        g, _ = system.model(images, ray_o, ray_d, t)
    act = rz.Gaussians(*(x[0] for x in g)).activate()
    cov3d = gs_math.build_cov3d(act.scaling, act.rotation)
    cam = cam_lib.CameraParams(*(x[0, 1] for x in cam_lib.make_camera(
        c2w, fxy_t, RES, RES)))
    pre = rz.preprocess_view(act, cov3d, cam, RES, RES, g.sh_degree)
    pre, _ = rz._clip_rect_centered(pre, system.cfg.raster
                                    .max_tiles_per_gaussian)
    tiles_x = RES // rz.TILE
    bins = rz._bin_tiles_single(pre, tiles_x, tiles_x, system.cfg.raster)
    packed = rz.pack_rows(pre)
    args = (packed, bins.idx, bins.counts, tiles_x)
    out = blend_kernel.blend_tiles(*args)
    ref = blend_kernel.blend_tiles_ref(*args)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    ms = cuda_ms(lambda: blend_kernel.blend_tiles(*args), 20)
    plain_ms = cuda_ms(lambda: blend_kernel.blend_tiles_ref(*args), 2)
    res = {"max_abs_err": max(errs), "err_t_fin": errs[0],
           "err_acc_c": errs[1], "err_acc_d": errs[2],
           "ms": ms, "plain_ms": plain_ms,
           "shape": f"T={bins.idx.shape[0]} K={bins.idx.shape[1]} "
                    f"N={packed.shape[0] - 1}",
           "mean_count": float(bins.counts.float().mean()),
           "overflow_gaussians": int(bins.overflow_gaussians)}
    print(f"[4 blend] {json.dumps(res)}", flush=True)
    if not max(errs) <= BLEND_ABS_BOUND:
        raise AssertionError(f"blend kernel: max abs error {max(errs):.3g} "
                             f"> {BLEND_ABS_BOUND}")
    return res


def phase_main(torch, dev, system) -> dict:
    import numpy as np

    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    pipe = DiffusionGSPipeline(system)
    kw = dict(resolution=RES, n_views=N_VIEWS, matting="border")
    pipe.batch([IMAGE], **kw)                       # warm-up run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "sphere.ply")
        attention.LAUNCHES = 0
        blend_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        out = pipe.batch([IMAGE], save_ply=[ply], **kw)[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"attention": attention.LAUNCHES,
                    "blend": blend_kernel.LAUNCHES}
        ply_bytes = os.path.getsize(ply)
        with open(ply, "rb") as f:
            header = f.read(4096).split(b"end_header")[0].decode("ascii")
    n_layers = len(system.model.transformer)
    want = {"attention": n_layers * STEPS,
            "blend": (STEPS - 1) * (N_VIEWS - 1) + N_VIEWS}
    g = out.gaussians
    res = {"seconds_per_asset": secs,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": launches, "expected_launches": want,
           "gaussians_after_filters": int(g.xyz.shape[0]),
           "renders_shape": list(out.renders.shape),
           "overflow": out.stats, "ply_bytes": ply_bytes,
           "card": card_line()}
    print(f"[5 main path] {json.dumps(res)}", flush=True)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if list(out.renders.shape) != [N_VIEWS, 3, RES, RES]:
        raise AssertionError(f"renders shape {out.renders.shape}")
    if not np.isfinite(out.renders).all():
        raise AssertionError("non-finite renders")
    if not all(np.isfinite(x).all() for x in g):
        raise AssertionError("non-finite Gaussians")
    if f"element vertex {g.xyz.shape[0]}" not in header or ply_bytes <= 0:
        raise AssertionError("PLY not written as expected")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import logging
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import open_diffusiongs_tpu_torch as port
    dev = port.require_cuda()

    phase_device(torch)
    phase_build()
    attn = phase_attention(torch, dev)
    system = build_system(torch, dev)
    blend = phase_blend(torch, dev, system)
    main_res = phase_main(torch, dev, system)

    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "flax", "optax", "orbax")
                    or m.startswith(("jax.", "open_diffusiongs_tpu."))
                    or m == "open_diffusiongs_tpu")
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")

    src = "open_diffusiongs_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_mha_packed", "route": "cuda",
         "source": src + "flash_attn_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/attention.py:221",
         "launches": main_res["launches"]["attention"],
         "max_abs_err": attn["max_abs_err"], "ms": attn["ms"],
         "plain_ms": attn["plain_ms"]},
        {"name": "blend_tiles", "route": "cuda",
         "source": src + "blend_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/blend_kernel.py:63",
         "launches": main_res["launches"]["blend"],
         "max_abs_err": blend["max_abs_err"], "ms": blend["ms"],
         "plain_ms": blend["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
