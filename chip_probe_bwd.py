#!/usr/bin/env python3
"""Probes of the general route's attention backward (#5b,
ops/attention.py::flash_full_mha_bwd) on one card: its checks, and what
each way of timing it counts.

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
                re.findall(r"C75(?:14|15|19|20)", log))
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


def _variant_lib(cs, tmp: str, i: int, edits, profile=False) -> str:
    """flash_full_bwd.cu with `edits`, built alone into a shared library."""
    import shutil
    import subprocess

    from open_diffusiongs_tpu_torch.ops import _build
    text = (_build.CSRC / "flash_full_bwd.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"{old!r} not in flash_full_bwd.cu")
        text = text.replace(old, new)
    if profile:
        text = _profile_source(text)
    shutil.copy(_build.CSRC / "hopper.cuh", tmp)
    src = os.path.join(tmp, f"t{i}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(tmp, f"libt{i}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    return lib


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
            libs = list(pool.map(lambda a: _variant_lib(cs, tmp, *a),
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
        lib = ctypes.CDLL(_variant_lib(cs, tmp, 0, (), profile=True))
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


def mode_check(torch, cs, dev) -> None:
    cs.phase_general_train_kernels(torch, dev)
    torch.cuda.empty_cache()
    cs.phase_wide_kernels(torch, dev)


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    modes = {"check": mode_check, "time": mode_time, "ptxas": mode_ptxas,
             "variants": mode_variants, "profile": mode_profile}
    if mode not in modes:
        print(__doc__)
        return 2
    torch, cs, dev = _setup()
    modes[mode](torch, cs, dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
