"""Packed-layout full multi-head attention: CUDA kernel + plain PyTorch twin.

Counterpart of open_diffusiongs_tpu/ops/attention.py::flash_mha_packed.
The kernel (csrc/flash_attn_fwd.cu) is hand-written for sm_90a; the plain
version `flash_mha_packed_ref` computes the same function with an explicit
f32 matmul and a masked base-2 softmax.  `flash_mha_packed` takes the plain
version only for CPU tensors (the test oracle); on a CUDA tensor it
launches the kernel or raises — never a silent fallback.

The JAX DiT pads the token axis once around the whole stack to a block
multiple (transformer.py:525-538, plan_packed :125-139: 4098 -> 4608 at
256^2).  The port's kernel masks the ragged tile itself, so the port's
DiT runs at Lp = L; the real rows agree either way.
"""

from __future__ import annotations

import math

import torch

from . import _build

LOG2E = math.log2(math.e)

LAUNCHES = 0   # kernel launches by flash_mha_packed (CUDA tensors only)


def _check_shapes(q, k, v, num_heads: int, l_real: int):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [b, Lp, h*dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, lp, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} is not divisible by {num_heads} heads")
    if not 1 <= l_real <= lp:
        raise ValueError(f"l_real={l_real} outside [1, Lp={lp}]")
    return b, lp, hd, hd // num_heads


def flash_mha_packed_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, num_heads: int, l_real: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: explicit f32 matmuls and a
    softmax in base 2 over the keys < l_real.  q is pre-scaled by
    dh^-1/2·log2(e) and rounded to q's dtype first, as in the kernel.
    Returns [b, Lp, h*dh] in q's dtype; rows >= l_real are garbage."""
    b, lp, hd, dh = _check_shapes(q, k, v, num_heads, l_real)
    scale = dh ** -0.5 * LOG2E
    qs = (q.float() * scale).to(q.dtype).float()
    heads = lambda x, n: x[:, :n].float().reshape(  # noqa: E731
        b, n, num_heads, dh).transpose(1, 2)        # [b, h, n, dh]
    s = torch.matmul(heads(qs, lp), heads(k, l_real).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    o = torch.matmul(p, heads(v, l_real)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(b, lp, hd).to(q.dtype)


def flash_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     num_heads: int, l_real: int) -> torch.Tensor:
    """Full MHA on the packed layout [b, Lp, h*dh] (head h in columns
    h*dh .. h*dh+dh-1); keys >= l_real are excluded.  Returns a new
    contiguous [b, Lp, h*dh] tensor in q's dtype (pad rows garbage).

    CPU tensors: `flash_mha_packed_ref`.  CUDA tensors: the sm_90a kernel,
    which takes bf16, dh in {32, 64} (the flagship's 64 and the tiny
    configs' 32), a contiguous last dimension and 16-byte aligned rows —
    q/k/v may be column slices of one fused qkv projection."""
    global LAUNCHES
    b, lp, hd, dh = _check_shapes(q, k, v, num_heads, l_real)
    if q.device.type == "cpu":
        return flash_mha_packed_ref(q, k, v, num_heads=num_heads,
                                    l_real=l_real)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_mha_packed: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got "
                            f"{x.dtype}")
        if x.stride(2) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
        if x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8:
            raise ValueError(f"{name}: rows must start 16-byte aligned "
                             f"(strides {x.stride()})")
    if dh not in (32, 64):
        raise ValueError(f"head dim {dh}: the kernel takes dh 32 or 64")
    out = torch.empty((b, lp, hd), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    err = lib.odgs_flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lp,
        num_heads, dh, l_real, dh ** -0.5 * LOG2E,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_mha_packed")
    LAUNCHES += 1
    return out
