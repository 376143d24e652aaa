"""Time the attention variants on one GPU: the bench variants of the
general-route kernel (the counterpart of tools/bench_attn2.py::mha_full)
and the scalar-max packed forward (the `smax` rows of tools/bench_attn3.py).

  python -m open_diffusiongs_tpu_torch.tools.bench_attn [--l 16386]
      [--heads 16] [--iters 20] [--check]

Prints one JSON line: per variant the mean device ms over `--iters`
launches (CUDA events, after warm-up) and the function's TFLOP/s at
4·L²·h·d (bench_attn2's count, :209; the f32-P variants run three bf16
products, 6·L²·h·d, on the tensor cores), with the card's name and power
limit.  No peak share: bench_attn2's PEAK_BF16 is a TPU figure.  `--check` runs
bench_attn2's check case (700 real rows padded with zeros to 1024, 16 heads
of 64) through every variant and holds it against its plain twin (max abs
error < 2e-2, bench_attn2 :176).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..ops import attention

# name -> (pv_f32, score_bf16), bench_attn2's variant flags
VARIANTS = {"mha_full": (False, False), "mha_full_pvf32": (True, False),
            "mha_full_sbf16": (False, True),
            "mha_full_pvf32_sbf16": (True, True)}
SMAX = "flash_mha_packed_smax"
CHECK_BAR = 2e-2           # max abs error vs the twin (bench_attn2 :176)
CHECK_L, CHECK_LP = 700, 1024
D = 64
TPU_KNOBS = ("ATTN_BLOCKS", "ATTN_SPECS", "ATTN_V2")
NOTE = ("The TPU tools' block-size specs (ATTN_BLOCKS / ATTN_SPECS: bq, bkv, "
        "pad, gc; ATTN_V2) do not apply and are not read: the GPU kernels "
        "run fixed 128-row q tiles over 128-key tiles and pad nothing.  The "
        "TPU's `sub` (tile / bcast) switch gives identical results and has "
        "no counterpart.")


def card_line() -> str:
    """`name, power limit` of the first card, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return (res.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


def _qkv(gen, dev, heads: int, lp: int, l_real: int):
    """q (pre-scaled as mha_full expects), k, v [h, Lp, 64] bf16 and the
    raw q; rows >= l_real zero."""
    x = torch.randn((3, heads, lp, D), generator=gen, device=dev)
    x[:, :, l_real:] = 0
    q, k, v = x.to(torch.bfloat16)
    return attention._full_prescaled_q(q), k, v, q


def _packed(*xs: torch.Tensor) -> tuple:
    """[h, L, d] -> column slices of one fused [1, L, 3·h·d] tensor."""
    fused = torch.cat([x.transpose(0, 1).reshape(1, x.shape[1], -1)
                       for x in xs], dim=-1)
    return fused.chunk(len(xs), dim=-1)


def _errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    err = float((out.float() - ref.float()).abs().max())
    return {"max_abs_err": err,
            "rel_max_err": err / float(ref.float().abs().max())}


def check(dev, heads: int = 16, seed: int = 0) -> dict:
    """bench_attn2's check case through each variant and the scalar-max
    forward, each against its plain twin on the same inputs (real rows)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qs, k, v, q = _qkv(gen, dev, heads, CHECK_LP, CHECK_L)
    out = {}
    for name, (pv_f32, score_bf16) in VARIANTS.items():
        kw = dict(l_real=CHECK_L, pv_f32=pv_f32, score_bf16=score_bf16)
        got = attention.mha_full(qs, k, v, **kw)
        ref = attention.mha_full_ref(qs, k, v, **kw)
        out[name] = _errors(got[:, :CHECK_L], ref[:, :CHECK_L])
    pq, pk, pv = _packed(q, k, v)
    kw = dict(num_heads=heads, l_real=CHECK_L, scalar_max=True)
    got = attention.flash_mha_packed(pq, pk, pv, **kw)
    ref = attention.flash_mha_packed_ref(
        pq, pk, pv, block_rows=attention.SMAX_BLOCK_ROWS, **kw)
    out[SMAX] = _errors(got[:, :CHECK_L], ref[:, :CHECK_L])
    return out


def _ms(fn, iters: int, warmup: int = 2) -> float:
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


def sweep(dev, l: int, heads: int = 16, iters: int = 20, seed: int = 0
          ) -> dict:
    """ms and the function's TFLOP/s of each variant at L = l (no padding:
    every row real) and of the scalar-max forward on column slices of a
    fused qkv, as the DiT hands it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qs, k, v, q = _qkv(gen, dev, heads, l, l)
    flop = 4.0 * l * l * heads * D
    out = {}
    runs = {name: (lambda f=flags: attention.mha_full(
                qs, k, v, l_real=l, pv_f32=f[0], score_bf16=f[1]))
            for name, flags in VARIANTS.items()}
    pq, pk, pv = _packed(q, k, v)
    runs[SMAX] = lambda: attention.flash_mha_packed(
        pq, pk, pv, num_heads=heads, l_real=l, scalar_max=True)
    for name, fn in runs.items():
        ms = _ms(fn, iters)
        out[name] = {"ms": ms, "tflops": flop / (ms * 1e-3) / 1e12}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m open_diffusiongs_tpu_torch.tools.bench_attn",
        description=__doc__.split("\n\n")[0], epilog=NOTE)
    ap.add_argument("--l", type=int, default=16386,
                    help="token count (16386: the 512^2 DiT)")
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--check", action="store_true",
                    help="hold every variant against its plain twin on "
                         "bench_attn2's check case instead of timing")
    args = ap.parse_args(argv)
    set_knobs = [k for k in TPU_KNOBS if k in os.environ]
    if set_knobs:
        print(f"bench_attn: ignoring {', '.join(set_knobs)}: {NOTE}",
              file=sys.stderr)
    from .. import require_cuda
    dev = require_cuda()
    res = {"card": card_line(),
           "device": {"kind": torch.cuda.get_device_name(dev),
                      "count": torch.cuda.device_count()}}
    if args.check:
        res["check"] = check(dev, args.heads)
        bad = {k: r["max_abs_err"] for k, r in res["check"].items()
               if not r["max_abs_err"] < CHECK_BAR}
        print(json.dumps(res))
        if bad:
            print(f"bench_attn: max abs error >= {CHECK_BAR}: {bad}",
                  file=sys.stderr)
            return 1
        return 0
    res.update(l=args.l, heads=args.heads, iters=args.iters,
               results=sweep(dev, args.l, args.heads, args.iters))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
