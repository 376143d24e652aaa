#!/usr/bin/env python3
"""Probes of the general route's attention kernels on one card: the
backward (#5b, ops/attention.py::flash_full_mha_bwd) and the training
forward (#5s, flash_full_mha_stats): their checks, what each way of timing
them counts, and what each design move is worth.

    python3 chip_probe_bwd.py check   # the build (ptxas report), then
                                      # chip_smoke.py's phases 16a and 21a:
                                      # #5s / #5b against their twins,
                                      # determinism, the prep launch, times
    python3 chip_probe_bwd.py time    # #5b at b = 4, L = 4098 (16 heads of
                                      # 64 and 48, 8 of 128) by CUDA events
                                      # over back-to-back calls, by CUDA-
                                      # graph replay, by torch.profiler
                                      # (chip_smoke.py::device_ms_by_kernel
                                      # at 10 calls and at 1, with each
                                      # kernel's record count and the host's
                                      # launch calls), and the wrapper's
                                      # host time per call

    python3 chip_probe_bwd.py ptxas   # csrc/flash_full_bwd.cu compiled
                                      # as built and with its setmaxnreg
                                      # counts changed (consumers 232 /
                                      # producer 40; none at all): ptxas'
                                      # registers and spills of each

    python3 chip_probe_bwd.py variants  # #5b's main pass rebuilt with
                                      # one piece taken out at a time (the
                                      # hand-off wait, the dQ read-modify-
                                      # write, the dQ^T product): CUDA-event
                                      # ms at 16 heads of 64 and 8 of 128,
                                      # the cost of each piece (the outputs
                                      # of those builds are wrong on purpose)

    python3 chip_probe_bwd.py fwd-time  # the general route's training
                                      # forward #5s at b = 4, L = 4098
                                      # (16 heads of 64 and 48, 8 of 128)
                                      # and splash_mha at b = 1, 8 of 128,
                                      # by CUDA events and CUDA-graph
                                      # replay beside SDPA's forward and
                                      # the bound; #5 and #6 (flash_full_mha,
                                      # mha_full's bf16-P variant) at b = 1,
                                      # 16 heads of 64
    python3 chip_probe_bwd.py fwd-variants  # #5s rebuilt with one design
                                      # move taken out at a time (the
                                      # warpgroups' turns, the stale max,
                                      # the SFU exp2, the persistent grid):
                                      # CUDA-event ms at 16 heads of 64 and
                                      # 8 of 128, and each build's o / lse
                                      # against the build as it is
    python3 chip_probe_bwd.py fwd-steps  # chip_smoke.py's phases 16c (the
                                      # general-route train step) and 21b
                                      # (the wide-head DiT's asset and
                                      # step): device ms by profiler

PROBE_ROOT=<dir> runs the package of another checkout (an earlier commit
unpacked under build/) in place of this one's, for a comparison in one
call.  Every mode prints `[probe ...]` JSON lines and the card's name and
power limit; it needs one card and builds the kernels as chip_smoke.py's
build does.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((4, 4098, 16, 64), (4, 4098, 16, 48), (4, 4098, 8, 128))


def _setup():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_probe_bwd: no CUDA device")
    import chip_smoke as cs
    root = os.environ.get("PROBE_ROOT")
    if root:
        sys.path.insert(0, os.path.abspath(root))
    import open_diffusiongs_tpu_torch as port
    print(f"[probe] package {os.path.dirname(port.__file__)}", flush=True)
    dev = port.require_cuda()
    cs.phase_device(torch)
    cs.phase_build()
    return torch, cs, dev


def profiled(torch, fn, iters: int) -> dict:
    """torch.profiler over `iters` calls of fn() (warmed up): per kernel
    name its records, their summed device ms (by key_averages, as
    chip_smoke.py::device_ms_by_kernel reads them, and by the raw events'
    own durations), and the host's kernel-launch calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            kernels[e.key[:60]] = {"records": e.count,
                                   "ms_per_call": e.self_device_time_total
                                   / 1e3 / iters}
        if e.key.startswith("cudaLaunchKernel"):
            launches += e.count
    raw = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            r = raw.setdefault(e.name[:60], [0, 0.0])
            r[0] += 1
            r[1] += e.time_range.elapsed_us() / 1e3 / iters
    del prof
    return {"key_averages": kernels, "raw_events": raw,
            "host_kernel_launch_calls": launches, "iters": iters}


def mode_time(torch, cs, dev) -> None:
    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(16)
    for b, n, h, d in SHAPES:
        _, (q, k, v, o, do, lse) = cs.general_train_case(
            torch, dev, gen, b, n, h, d, 0, n, n, False)

        def bwd():
            return attention.flash_full_mha_bwd(q, k, v, o, do, lse)

        bwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            bwd()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        res = {"shape": f"b={b} L={n} h={h} d={d}",
               "events_ms": cs.cuda_ms(bwd, 20),
               "graph_ms": cs.graph_ms(bwd, 20),
               "host_us_per_call": host_us,
               "device_ms_by_kernel_10": cs.device_ms_by_kernel(torch, bwd),
               "device_ms_by_kernel_1": cs.device_ms_by_kernel(torch, bwd,
                                                               iters=1),
               "profiled_10": profiled(torch, bwd, 10),
               "profiled_1": profiled(torch, bwd, 1),
               "events_ms_again": cs.cuda_ms(bwd, 20),
               "card": cs.card_line()}
        for key in ("device_ms_by_kernel_10", "device_ms_by_kernel_1"):
            res[key + "_sum"] = sum(res[key].values())
        print(f"[probe time] {json.dumps(res)}", flush=True)
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()


# (name, replacements in the source): whether ptxas budgets the consumer
# warpgroups' code by their setmaxnreg count or by the launch bound
PTXAS_VARIANTS = (
    ("as built", ()),
    ("consumers 232, producer 40", (("setmaxnreg_inc<224>",
                                     "setmaxnreg_inc<232>"),
                                    ("setmaxnreg_dec<56>",
                                     "setmaxnreg_dec<40>"))),
    ("no setmaxnreg", (("setmaxnreg_inc<224>();", ""),
                       ("setmaxnreg_dec<56>();", ""))))


def mode_ptxas(torch, cs, dev) -> None:
    import re
    import shutil
    import subprocess
    import tempfile

    from open_diffusiongs_tpu_torch.ops import _build
    src = (_build.CSRC / "flash_full_bwd.cu").read_text()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        shutil.copy(_build.CSRC / "hopper.cuh", tmp)
        jobs = []
        for i, (name, edits) in enumerate(PTXAS_VARIANTS):
            text = src
            for old, new in edits:
                if old not in text:
                    raise AssertionError(f"{name}: {old!r} not in the source")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-c", "-o",
                   path + ".o", path]
            jobs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        out = {}
        for name, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode:
                raise AssertionError(f"{name}: nvcc failed\n{log}")
            out[name] = {k: v for k, v in cs.ptxas_summary(
                log, "flash_full_bwd").items()}
            out[name]["serialisation_warnings"] = len(
                re.findall(cs.SERIALISATION, log))
    print(f"[probe ptxas] {json.dumps(out)}", flush=True)


# (name, replacements in flash_full_bwd.cu): builds timed, not checked
TIME_VARIANTS = (
    ("as built", ()),
    ("no hand-off wait", (("if (!first) wait_count(p.cnt + tile, "
                           "(unsigned)kb);", ""),)),
    ("no dQ read-modify-write", (("for (int i0 = lane; i0 < T::NV; ",
                                  "for (int i0 = T::NV; i0 < T::NV; "),)),
    ("no dQ^T product", (("for (int kj = 0; kj < BLOCK / 16; ++kj)   "
                          "// dQ^T", "for (int kj = 0; kj < 0; ++kj)   "
                                     "// dQ^T"),)),
    ("stage slot freed before the add loop", (
        ("if (!first) wait_count(p.cnt + tile, (unsigned)kb);",
         "if (!first) wait_count(p.cnt + tile, (unsigned)kb);\n"
         "      __syncwarp();\n"
         "      if (lane == 0) mbar_arrive(&s.st_empty[wi]);"),
        ("        mbar_arrive(&s.st_empty[wi]);\n", ""))),
    ("dQ accumulator not read", (("a[u] = __ldcg(acc + i0 + 32 * u);",
                                  "a[u] = make_float4(0.f, 0.f, 0.f, "
                                  "0.f);"),)),
    ("no P^T / dS^T stores", (("        *reinterpret_cast<uint32_t*>(psb + "
                               "off) = pack_bf16x2(pv[0], pv[1]);\n"
                               "        *reinterpret_cast<uint32_t*>(dsb + "
                               "off) = pack_bf16x2(ds[0], ds[1]);\n",
                               "        if (pv[0] == 1.2345e-38f) "
                               "*reinterpret_cast<uint32_t*>(psb + off) = "
                               "pack_bf16x2(pv[1], ds[0] + ds[1]);\n"),)),
)

# Clock counts of the main pass's phases, written past the end of the dQ
# accumulator (8 floats a writer warp, then 8 a consumer warpgroup)
PROFILE_EDITS = (
    ("  int tw = 0;   // tiles handed off so far, by all writers\n",
     "  int tw = 0;   // tiles handed off so far, by all writers\n"
     "  float tf = 0.f, tc = 0.f, tl = 0.f, tr = 0.f, nt = 0.f;\n"),
    ("      mbar_wait_bounded(&s.st_full[wi], (tw / NWRITER) & 1);\n",
     "      long long c0 = clock64();\n"
     "      mbar_wait_bounded(&s.st_full[wi], (tw / NWRITER) & 1);\n"
     "      long long c1 = clock64(); tf += c1 - c0;\n"),
    ("      if (!first) wait_count(p.cnt + tile, (unsigned)kb);\n",
     "      if (!first) wait_count(p.cnt + tile, (unsigned)kb);\n"
     "      long long c2 = clock64(); tc += c2 - c1;\n"),
    ("      if (!last) __threadfence();\n      __syncwarp();\n",
     "      long long c3 = clock64(); tl += c3 - c2;\n"
     "      if (!last) __threadfence();\n      __syncwarp();\n"),
    ("        if (!last) st_release(p.cnt + tile, (unsigned)kb + 1u);\n"
     "      }\n",
     "        if (!last) st_release(p.cnt + tile, (unsigned)kb + 1u);\n"
     "      }\n      tr += clock64() - c3; nt += 1.f;\n"),
    ("template <int DH>\n__device__ __forceinline__ void consumer(",
     "template <int DH>\n__device__ __forceinline__ void consumer("),
)


def _profile_source(text: str) -> str:
    """flash_full_bwd.cu with PROFILE_EDITS and the two result writes."""
    for old, new in PROFILE_EDITS:
        if old not in text:
            raise AssertionError(f"{old!r} not in flash_full_bwd.cu")
        text = text.replace(old, new, 1)
    # writer totals, at the end of writer()
    end = text.index("template <int DH>\n__device__ __forceinline__ void "
                     "consumer(")
    close = text.rindex("}\n", 0, end)
    text = (text[:close] + "  if (lane == 0) {\n"
            "    float* o = p.acc + (long long)p.bh * p.n_qt * Tile<DH>::QS "
            "* DH + ((g * p.n_kb + kb) * NWRITER + wi) * 8;\n"
            "    o[0] = kb; o[1] = nt; o[2] = tf; o[3] = tc; o[4] = tl; "
            "o[5] = tr;\n  }\n" + text[close:])
    # consumer: the step's phases (overlap path): the score products, the
    # P^T / dS^T tiles, the rest of the gradient products
    text = text.replace(
        "        issue_scores(t + 1);\n        issue_grads(t);\n"
        "        wgmma_wait<1>();\n        make_tiles(t + 1);\n"
        "        grads_done(t);\n",
        "        long long k0 = clock64();\n"
        "        issue_scores(t + 1);\n        issue_grads(t);\n"
        "        wgmma_wait<1>();\n        long long k1 = clock64();\n"
        "        make_tiles(t + 1);\n        long long k2 = clock64();\n"
        "        wgmma_wait<0>();\n        long long k3 = clock64();\n"
        "        grads_done(t);\n"
        "        cs1 += k1 - k0; cs2 += k2 - k1; cs3 += k3 - k2;\n", 1)
    # consumer: cycles waiting for the stage slot and for the ring, total
    text = text.replace(
        "    mbar_wait_bounded(&s.st_empty[sb], ((t / NWRITER) & 1) ^ 1);",
        "    long long w0 = clock64();\n"
        "    mbar_wait_bounded(&s.st_empty[sb], ((t / NWRITER) & 1) ^ 1);\n"
        "    cst += clock64() - w0;", 1)
    text = text.replace(
        "  auto wait_full = [&](int t) {\n",
        "  float cst = 0.f, cfu = 0.f, cs1 = 0.f, cs2 = 0.f, cs3 = 0.f;\n"
        "  const long long cstart = clock64();"
        "\n  auto wait_full = [&](int t) {\n    long long w0 = clock64();\n",
        1)
    text = text.replace(
        "    mbar_wait_bounded(&s.full[t % NSTAGE], (t / NSTAGE) & 1);\n  };",
        "    mbar_wait_bounded(&s.full[t % NSTAGE], (t / NSTAGE) & 1);\n"
        "    cfu += clock64() - w0;\n  };", 1)
    end = text.index("template <int DH>\n__global__ void __launch_bounds__")
    close = text.rindex("}\n", 0, end)
    text = (text[:close] + "  if (tid == 0) {\n"
            "    float* o = p.acc + (long long)p.bh * p.n_qt * Tile<DH>::QS "
            "* DH + (p.groups * p.n_kb * NWRITER + (g * p.n_kb + kb) * 2 + w)"
            " * 8;\n"
            "    o[0] = kb; o[1] = tt; o[2] = cst; o[3] = cfu; "
            "o[4] = clock64() - cstart; o[5] = cs1; o[6] = cs2; o[7] = cs3;"
            "\n  }\n" + text[close:])
    return text


def _variant_lib(source: str, tmp: str, i: int, edits,
                 transform=None) -> str:
    """csrc/`source` with `edits` (then `transform` of the text), built
    alone into a shared library under tmp; its nvcc / ptxas output goes to
    VARIANT_LOGS."""
    import shutil
    import subprocess

    from open_diffusiongs_tpu_torch.ops import _build
    text = (_build.CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"{old!r} not in {source}")
        text = text.replace(old, new)
    if transform:
        text = transform(text)
    shutil.copy(_build.CSRC / "hopper.cuh", tmp)
    stem = os.path.splitext(source)[0]
    src = os.path.join(tmp, f"{stem}_{i}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(tmp, f"lib{stem}_{i}.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", lib, src], capture_output=True, text=True)
    if res.returncode:
        raise AssertionError(f"nvcc failed on {src}:\n{res.stderr}")
    VARIANT_LOGS[lib] = res.stdout + res.stderr
    return lib


VARIANT_LOGS = {}   # a variant library's path -> its nvcc / ptxas output


def mode_variants(torch, cs, dev) -> None:
    import ctypes
    import tempfile

    from open_diffusiongs_tpu_torch.ops import _build, attention
    gen = torch.Generator(device=dev).manual_seed(16)
    inputs = {f"{h}x{d}": cs.general_train_case(torch, dev, gen, 4, 4098, h,
                                                d, 0, 4098, 4098, False)[1]
              for h, d in ((16, 64), (8, 128))}
    real = _build.load_library()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(TIME_VARIANTS)) as pool:
            libs = list(pool.map(
                lambda a: _variant_lib("flash_full_bwd.cu", tmp, *a),
                enumerate(e for _, e in TIME_VARIANTS)))
        for (name, _), path in zip(TIME_VARIANTS, libs):
            lib = ctypes.CDLL(path)
            for fn in ("odgs_flash_full_bwd_prep_bf16",
                       "odgs_flash_full_bwd_bf16"):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
            _build._lib = lib
            try:
                out[name] = {key: cs.cuda_ms(
                    lambda x=x: attention.flash_full_mha_bwd(*x), 20)
                    for key, x in inputs.items()}
            finally:
                _build._lib = real
    out["card"] = cs.card_line()
    print(f"[probe variants] {json.dumps(out)}", flush=True)


def mode_profile(torch, cs, dev) -> None:
    """The main pass's phase clocks at b = 4, L = 4098, 16 heads of 64: per
    writer warp the cycles waiting for its stage slot, for the hand-off,
    in the read-add-store loop and in fence + release; per consumer
    warpgroup the cycles waiting for a free stage slot, for the ring, and
    in all; averaged by key block."""
    import ctypes
    import tempfile

    from open_diffusiongs_tpu_torch.ops import _build, attention
    gen = torch.Generator(device=dev).manual_seed(16)
    x = cs.general_train_case(torch, dev, gen, 4, 4098, 16, 64, 0, 4098,
                              4098, False)[1]
    real, scratch = _build.load_library(), attention._full_bwd_scratch
    kept = []

    def padded(plan, *a):
        qs, delta, cnt, acc = scratch(plan, *a)
        acc = torch.zeros(acc.numel() + plan.grid * (3 + 2) * 8,
                          dtype=torch.float32, device=acc.device)
        kept.append((plan, acc))
        return qs, delta, cnt, acc

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        lib = ctypes.CDLL(_variant_lib("flash_full_bwd.cu", tmp, 0, (),
                                       _profile_source))
    for fn in ("odgs_flash_full_bwd_prep_bf16", "odgs_flash_full_bwd_bf16"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    _build._lib, attention._full_bwd_scratch = lib, padded
    try:
        ms = cs.cuda_ms(lambda: attention.flash_full_mha_bwd(*x), 5)
        kept.clear()
        attention.flash_full_mha_bwd(*x)
        torch.cuda.synchronize()
    finally:
        _build._lib, attention._full_bwd_scratch = real, scratch
    plan, acc = kept[0]
    used = plan.acc_shape[0] * plan.acc_shape[1] * plan.acc_shape[2]
    tail = acc[used:].view(-1, 8).cpu()
    nw = plan.grid * 3
    res = {"ms": ms, "clock_ghz_note": "cycles of the SM clock"}
    for name, rows, cols in (("writers", tail[:nw], ("tiles", "stage_full",
                                                      "hand_off", "loop",
                                                      "fence_release")),
                             ("consumers", tail[nw:], ("tiles", "stage_empty",
                                                        "ring_full", "total",
                                                        "scores", "tiles_pds",
                                                        "grads_rest"))):
        by_kb = {}
        for r in rows.tolist():
            by_kb.setdefault(int(r[0]), []).append(r[1:1 + len(cols)])
        res[name] = {kb: [sum(c) / len(v) for c in zip(*v)]
                     for kb, v in sorted(by_kb.items())
                     if kb in (0, 1, 16, plan.n_key_blocks - 1)}
        res[name]["columns"] = cols
    res["card"] = cs.card_line()
    print(f"[probe profile] {json.dumps(res)}", flush=True)


FWD_SHAPES = ((4, 4098, 16, 64), (4, 4098, 16, 48), (4, 4098, 8, 128))


def mode_fwd_time(torch, cs, dev) -> None:
    import torch.nn.functional as F

    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(19)
    out = {}

    def timed(fn, sdpa, bound):
        return {"events_ms": cs.cuda_ms(fn, 20),
                "graph_ms": cs.graph_ms(fn, 20),
                "events_ms_again": cs.cuda_ms(fn, 20),
                "sdpa_ms": cs.cuda_ms(sdpa, 20), **bound}

    for b, n, h, d in FWD_SHAPES + ((1, 4098, 8, 128),):
        q, k, v = cs.fused_heads(torch, dev, gen, b, n, h, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fn = (attention.flash_full_mha_stats if b > 1
              else attention.splash_mha)
        out[f"{'5s' if b > 1 else 'splash_mha'} b={b} {h}x{d}"] = timed(
            lambda: fn(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            cs.attn_fwd_bound(b, n, n, h, d, stats=b > 1, pv="tf32"))
        del q, k, v, qt, kt, vt
    q, k, v = cs.fused_heads(torch, dev, gen, 1, 4098, 16, 64)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["5 b=1 16x64"] = timed(
        lambda: attention.flash_full_mha(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt),
        cs.attn_fwd_bound(1, 4098, 4098, 16, 64, pv="tf32"))
    qh, kh, vh = (x[0].transpose(0, 1).contiguous() for x in (q, k, v))
    out["6 (bf16 P) 16x64"] = timed(
        lambda: attention.mha_full(qh, kh, vh, l_real=4098),
        lambda: F.scaled_dot_product_attention(qt, kt, vt),
        cs.attn_fwd_bound(1, 4098, 4098, 16, 64))
    out["card"] = cs.card_line()
    print(f"[probe fwd-time] {json.dumps(out)}", flush=True)


# (name, replacements in flash_full_fwd.cu): #5s with one design move
# taken out; every build computes the same function
FWD_VARIANTS = (
    ("as built", ()),
    ("two consumers in ping-pong at DH <= 64 (DH = 128's schedule)", (
        ("static constexpr bool PINGPONG = DH > 64;",
         "static constexpr bool PINGPONG = DH > 0;"),)),
    ("two serial consumers at DH = 128 (no ping-pong)", (
        ("static constexpr bool PINGPONG = DH > 64;\n"
         "  static constexpr int NC = PINGPONG ? 2 : 3;",
         "static constexpr bool PINGPONG = false;\n"
         "  static constexpr int NC = DH > 64 ? 2 : 3;"),
        ("static constexpr int NST = PINGPONG ? 3 : 4;",
         "static constexpr int NST = DH > 64 ? 3 : 4;"),
        ("static constexpr int REGS = PINGPONG ? 240 : 160;",
         "static constexpr int REGS = DH > 64 ? 240 : 160;"),
        ("static constexpr int PRODUCER_REGS = PINGPONG ? 24 : 32;",
         "static constexpr int PRODUCER_REGS = DH > 64 ? 24 : 32;"))),
    ("no turns at DH = 128 (consumers unordered)", (
        ("auto take_turn = [&] { bar_sync(BAR_TURN + wg, 2 * WG); };",
         "auto take_turn = [&] {};"),
        ("auto pass_turn = [&] { bar_arrive(BAR_TURN + (wg ^ 1), 2 * WG); };",
         "auto pass_turn = [&] {};"))),
    ("max moved at every rise (tau 0)", (
        ("constexpr float RESCALE_TAU = 8.f;",
         "constexpr float RESCALE_TAU = 0.f;"),)),
    ("rescale every tile (tau 0, no skip)", (
        ("constexpr float RESCALE_TAU = 8.f;",
         "constexpr float RESCALE_TAU = 0.f;"),
        ("    if (__any_sync(FULL, moved)) {", "    if (moved || true) {"))),
    ("exp2f in place of ex2.approx", (
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = exp2f(x);"),)),
    ("one CTA a q tile (not persistent)", (
        ("const int ctas = grid < p.n_tiles ? grid : p.n_tiles;",
         "const int ctas = p.n_tiles;"),)),
    ("S written through its old value (ss, not ss_init)", (
        ("    Wgmma<BK>::template ss_init<0>(sacc, kdesc_tile<DH>(qw, "
         "Sched<DH>::SQ, 0),\n"
         "                                   kdesc_tile<DH>(k, BK, 0));",
         "    Wgmma<BK>::template ss<0>(sacc, kdesc_tile<DH>(qw, "
         "Sched<DH>::SQ, 0),\n"
         "                              kdesc_tile<DH>(k, BK, 0), 0);"),)),
    ("3 stages at DH <= 64", (
        ("static constexpr int NST = PINGPONG ? 3 : 4;",
         "static constexpr int NST = PINGPONG ? 3 : 3;"),)),
    ("exp2 and the split in two loops at DH <= 64", (
        ("      r.exp_split();\n",
         "      {\n        float ls[2];\n        r.exp_in_place(ls);\n"
         "        r.l_run[0] += ls[0];\n        r.l_run[1] += ls[1];\n"
         "        r.split_in_place();\n      }\n"),)),
    # a piece of the work removed (outputs wrong on purpose): its cost
    ("no P_lo.V product (wrong)", (
        ("      mma_mn<DH>(oacc, plo[kj], v, BK, kj);\n", ""),)),
)


def mode_fwd_variants(torch, cs, dev) -> None:
    import ctypes
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from open_diffusiongs_tpu_torch.ops import _build, attention
    gen = torch.Generator(device=dev).manual_seed(19)
    inputs = {f"{h}x{d}": cs.fused_heads(torch, dev, gen, 4, 4098, h, d)
              for h, d in ((16, 64), (8, 128))}
    real = _build.load_library()
    fn = "odgs_flash_full_fwd_stats_bf16"
    # PROBE_VARIANTS=1,4,... picks variants by index (0, as built, always)
    pick = os.environ.get("PROBE_VARIANTS")
    variants = [v for i, v in enumerate(FWD_VARIANTS)
                if not pick or i == 0 or str(i) in pick.split(",")]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out, ref = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = list(pool.map(
                lambda a: _variant_lib("flash_full_fwd.cu", tmp, *a),
                enumerate(e for _, e in variants)))
        for (name, _), path in zip(variants, libs):
            lib = ctypes.CDLL(path)
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
            _build._lib = lib
            try:
                res = {}
                for key, x in inputs.items():
                    o, lse = attention.flash_full_mha_stats(*x)
                    torch.cuda.synchronize()
                    if name == "as built":
                        ref[key] = (o, lse)
                    res[key] = {
                        "ms": cs.cuda_ms(
                            lambda x=x: attention.flash_full_mha_stats(*x),
                            20),
                        "o_max_abs_vs_built": float(
                            (o.float() - ref[key][0].float()).abs().max()),
                        "lse_max_abs_vs_built": float(
                            (lse - ref[key][1]).abs().max())}
                log = VARIANT_LOGS[path]
                res["ptxas"] = cs.ptxas_summary(log, "flash_full_stats_kernel")
                res["serialisation_warnings"] = len(re.findall(
                    cs.SERIALISATION, log))
                out[name] = res
            finally:
                _build._lib = real
    out["card"] = cs.card_line()
    print(f"[probe fwd-variants] {json.dumps(out)}", flush=True)


# Clock counts of #5s's consumer loops, per consumer warpgroup of each
# CTA, summed over its key tiles (then the key tiles and all cycles of the
# tile walk).  The serial loop (DH <= 64): waiting for the ring, S (issue
# and wait), the max and rescale, exp2 with the split, issuing P.V, waiting
# for it.  The ping-pong loop (DH = 128, key tiles j >= 1): waiting for the
# ring, the turn and issuing S_j and P_{j-1}.V_{j-1}, waiting for S_j, the
# max and exp2, waiting for P.V, the rescale and split.
FWD_PROFILE_COLUMNS = {
    "serial": ("ring_full", "s", "max_rescale", "exp_split", "pv_issue",
               "pv_wait"),
    "pingpong": ("ring_full", "turn_issue", "s_wait", "max_exp", "pv_wait",
                 "rescale_split")}
_PF = ("      pf[0] += k1 - k0; pf[1] += k2 - k1; pf[2] += k3 - k2; "
       "pf[3] += k4 - k3; pf[4] += k5 - k4; pf[5] += k6 - k5; pf[6] += 1.f;\n")
_PF_DECL = ("  float pf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n"
            "  const long long kstart = clock64();\n")
_PF_OUT = ("  pf[7] = clock64() - kstart;\n"
           "  if (r.tid == 0 && blockIdx.x < 1024)\n"
           "    for (int i = 0; i < 8; ++i)\n"
           "      g_prof[(blockIdx.x * 4 + wg) * 8 + i] = pf[i];\n}\n")
FWD_PROFILE_EDITS = (
    ("// DH <= 64: three consumers, each running a key tile in turn as S,",
     "__device__ float g_prof[4096 * 8];\n\n"
     "// DH <= 64: three consumers, each running a key tile in turn as S,"),
    # the serial loop
    ("span_of<DH>();   // its q~\n"
     "  int it = 0, ti = 0;   // key tiles and q tiles consumed so far\n",
     "span_of<DH>();   // its q~\n"
     "  int it = 0, ti = 0;   // key tiles and q tiles consumed so far\n"
     + _PF_DECL),
    ("      const int st = it % S::NST;\n"
     "      mbar_wait(&s.full[st], (it / S::NST) & 1);\n"
     "      wgmma_fence();\n      r.issue_s(qw, s.k[st]);\n",
     "      const int st = it % S::NST;\n      long long k0 = clock64();\n"
     "      mbar_wait(&s.full[st], (it / S::NST) & 1);\n"
     "      long long k1 = clock64();\n"
     "      wgmma_fence();\n      r.issue_s(qw, s.k[st]);\n"),
    ("      float alpha[2];\n"
     "      const bool moved = r.new_max(j, p.lk, alpha);\n"
     "      r.rescale(moved, alpha);\n      r.exp_split();\n"
     "      wgmma_fence();\n      r.issue_pv(s.v[st]);\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n      fence_regs(r.oacc);\n"
     "      if (r.tid == 0) mbar_arrive(&s.empty[st]);\n",
     "      long long k2 = clock64();\n"
     "      float alpha[2];\n"
     "      const bool moved = r.new_max(j, p.lk, alpha);\n"
     "      r.rescale(moved, alpha);\n      long long k3 = clock64();\n"
     "      r.exp_split();\n      long long k4 = clock64();\n"
     "      wgmma_fence();\n      r.issue_pv(s.v[st]);\n"
     "      wgmma_commit();\n"
     "      long long k5 = clock64();\n"
     "      wgmma_wait<0>();\n      fence_regs(r.oacc);\n"
     "      if (r.tid == 0) mbar_arrive(&s.empty[st]);\n"
     "      long long k6 = clock64();\n" + _PF),
    ("    r.store(p, q0, head, bi);\n  }\n}\n\n// DH = 128: two consumers",
     "    r.store(p, q0, head, bi);\n  }\n" + _PF_OUT
     + "\n// DH = 128: two consumers"),
    # the ping-pong loop
    ("  if (wg == 1) pass_turn();   // consumer 0 issues first\n",
     "  if (wg == 1) pass_turn();   // consumer 0 issues first\n" + _PF_DECL),
    ("      mbar_wait(&s.full[st], (c / S::NST) & 1);\n      take_turn();\n",
     "      long long k0 = clock64();\n"
     "      mbar_wait(&s.full[st], (c / S::NST) & 1);\n"
     "      long long k1 = clock64();\n      take_turn();\n"),
    ("      pass_turn();\n      wgmma_wait<1>();        // S_j is done",
     "      pass_turn();\n      long long k2 = clock64();\n"
     "      wgmma_wait<1>();        // S_j is done"),
    ("      const bool moved = r.new_max(j, p.lk, alpha);\n"
     "      r.exp_in_place(ls);\n      wgmma_wait<0>();\n",
     "      long long k3 = clock64();\n"
     "      const bool moved = r.new_max(j, p.lk, alpha);\n"
     "      r.exp_in_place(ls);\n      long long k4 = clock64();\n"
     "      wgmma_wait<0>();\n      long long k5 = clock64();\n"),
    ("      r.split_in_place();\n    }\n    const int last",
     "      r.split_in_place();\n      long long k6 = clock64();\n" + _PF
     + "    }\n    const int last"),
    ("    r.store(p, q0, head, bi);\n  }\n}\n\ntemplate <int DH>\n__global__",
     "    r.store(p, q0, head, bi);\n  }\n" + _PF_OUT
     + "\ntemplate <int DH>\n__global__"),
    ("// #5s (see the header): scale = bf16(d^-1/2)",
     "extern \"C\" int odgs_fwd_profile_read(void* dst, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_prof, n * "
     "sizeof(float), 0, cudaMemcpyDeviceToDevice));\n}\n\n"
     "// #5s (see the header): scale = bf16(d^-1/2)"),
)


def mode_fwd_profile(torch, cs, dev) -> None:
    """#5s's consumer phases by clock64 at b = 4, L = 4098 (16 heads of 64:
    the serial loop; 8 of 128: the ping-pong loop): cycles per key tile of
    each phase, averaged over the CTAs, per consumer warpgroup; the walk's
    cycles against the launch's ms give the SM clock (the probes slow the
    kernel: their ms is not #5s's)."""
    import ctypes
    import tempfile

    from open_diffusiongs_tpu_torch.ops import _build, attention
    gen = torch.Generator(device=dev).manual_seed(19)
    real = _build.load_library()
    fn = "odgs_flash_full_fwd_stats_bf16"
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        lib = ctypes.CDLL(_variant_lib("flash_full_fwd.cu", tmp, 0,
                                       FWD_PROFILE_EDITS))
    getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
    getattr(lib, fn).restype = ctypes.c_int
    lib.odgs_fwd_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.odgs_fwd_profile_read.restype = ctypes.c_int
    _build._lib = lib
    try:
        for h, d in ((16, 64), (8, 128)):
            x = cs.fused_heads(torch, dev, gen, 4, 4098, h, d)
            ms = cs.cuda_ms(lambda: attention.flash_full_mha_stats(*x), 10)
            attention.flash_full_mha_stats(*x)
            torch.cuda.synchronize()
            buf = torch.zeros(4096 * 8, dtype=torch.float32, device=dev)
            if lib.odgs_fwd_profile_read(buf.data_ptr(), buf.numel()):
                raise AssertionError("reading the profile failed")
            plan = attention.full_fwd_plan(
                4, 4098, 4098, h, d,
                torch.cuda.get_device_properties(0).multi_processor_count)
            sched = attention.full_fwd_schedule(plan.tile)
            cols = FWD_PROFILE_COLUMNS["pingpong" if sched.pingpong
                                       else "serial"]
            rows = buf[:plan.grid * 4 * 8].view(plan.grid, 4, 8).double().cpu()
            res = {"ms": ms, "loop": "pingpong" if sched.pingpong
                   else "serial"}
            for w in range(sched.consumers):
                r = rows[:, w]
                per = r[:, :6].sum(0) / r[:, 6].sum()
                res[f"wg{w}_cycles_per_key_tile"] = dict(zip(
                    cols, per.tolist()))
                res[f"wg{w}_total_cycles_mean"] = float(r[:, 7].mean())
            res["sm_ghz_from_walk"] = res["wg0_total_cycles_mean"] / (
                ms * 1e6)
            out[f"{h}x{d}"] = res
    finally:
        _build._lib = real
    out["card"] = cs.card_line()
    print(f"[probe fwd-profile] {json.dumps(out)}", flush=True)


def mode_fwd_steps(torch, cs, dev) -> None:
    step = cs.phase_general_train(torch, dev)
    torch.cuda.empty_cache()
    wide = cs.phase_wide_dit(torch, dev)
    keys = ("seconds_per_step", "device_ms_per_step",
            "attention_fwd_device_ms_per_step",
            "attention_bwd_device_ms_per_step")
    out = {"16c": {k: step.get(k) for k in keys},
           "21b step": {k: wide["train"].get(k) for k in keys},
           "21b asset": {k: wide["sampling"].get(k) for k in (
               "seconds_per_asset", "device_ms_per_asset",
               "general_kernel_device_ms_per_asset")},
           "card": cs.card_line()}
    print(f"[probe fwd-steps] {json.dumps(out)}", flush=True)


def mode_check(torch, cs, dev) -> None:
    cs.phase_general_train_kernels(torch, dev)
    torch.cuda.empty_cache()
    cs.phase_wide_kernels(torch, dev)


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    modes = {"check": mode_check, "time": mode_time, "ptxas": mode_ptxas,
             "variants": mode_variants, "profile": mode_profile,
             "fwd-time": mode_fwd_time, "fwd-variants": mode_fwd_variants,
             "fwd-steps": mode_fwd_steps, "fwd-profile": mode_fwd_profile}
    if mode not in modes:
        print(__doc__)
        return 2
    torch, cs, dev = _setup()
    modes[mode](torch, cs, dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
