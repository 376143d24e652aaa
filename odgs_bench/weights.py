"""Seeded weights, made on the device in one draw.

Every weight (a parameter whose name ends neither in `.bias` nor in a
LayerNorm's `.weight`) takes N(0, 0.02) from one `torch.randn` call of a
generator on the device, in the sorted order of the names; biases are 0
and LayerNorm scales 1 (`std` may set each drawn tensor's scale).  The
same seed and shapes give the same tensors,
so the program under test and the plain reference are handed equal
weights without either reading the other's.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

STD = 0.02


def is_scale(name: str) -> bool:
    return name.endswith("layernorm.weight")


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         std: Callable[[str, Tuple[int, ...]], float] = None
         ) -> Dict[str, torch.Tensor]:
    """`std(name, shape)`, when given, replaces 0.02 for each drawn
    tensor."""
    names = sorted(shapes)
    drawn = [n for n in names if not n.endswith(".bias") and not is_scale(n)]
    sizes = [torch.Size(shapes[n]).numel() for n in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    parts = flat.split(sizes)
    if std is None:
        flat.mul_(STD)
    else:
        for t, n in zip(parts, drawn):
            t.mul_(std(n, shapes[n]))
    out = dict(zip(drawn, (t.view(shapes[n]) for t, n in zip(parts, drawn))))
    for n in names:
        if n.endswith(".bias"):
            out[n] = torch.zeros(shapes[n], device=device)
        elif is_scale(n):
            out[n] = torch.ones(shapes[n], device=device)
    return out
