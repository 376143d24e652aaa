"""Which part of each DiT parameter a rank holds under tensor and pipeline
parallelism, and the cuts between whole and sharded state dicts.

Counterpart of open_diffusiongs_tpu/parallel/mesh.py::dit_tp_rule (:77-99)
and of `train_state_sharding`'s pipe rule (:102-165), on the port's
parameter names (the reference's):
  * column-parallel (split on the output axis, dim 0 of a torch weight):
    `attn.qkv` and `mlp.fc1`, weight rows and bias;
  * row-parallel (split on the input axis, dim 1): `attn.proj` and
    `mlp.fc2` weights; their biases stay whole and are added once, after
    the sum over `model` (models/transformer.py::Linear);
  * replicated: everything else (adaLN, the embedders, the heads,
    `q_norm` / `k_norm`).
The reference fuses q | k | v into one [3d, d] Linear; JAX splits it
because a fused axis cannot be head-aligned (mesh.py:80-82).  Model rank
m's qkv shard is therefore the rows of its heads in each third, q[m] |
k[m] | v[m], not a contiguous slice of the fused weight (`shard_tensor`).

Under pipeline parallelism stage p holds layers [p·L/S, (p+1)·L/S) of the
stack, named 0 .. L/S - 1 in its own module (`transformer.{i}`); every
other parameter is replicated over `pipe`.

`shard_state_dict` cuts a whole state dict (reference names and shapes)
into one rank's and `unshard_state_dicts` puts every rank's back together;
`gather_state_dict` does the latter across the ranks (a collective).
Checkpoints, ZeRO-1's gathers and the tests all go through these.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

STACK = "transformer."      # the denoiser's DiT stack in parameter names
_COLUMN = ("attn.qkv.weight", "attn.qkv.bias", "mlp.fc1.weight",
           "mlp.fc1.bias")
_ROW = ("attn.proj.weight", "mlp.fc2.weight")


def tp_dim(name: str) -> Optional[int]:
    """The axis tensor parallelism splits `name` on (0: column-parallel,
    1: row-parallel), or None for a replicated parameter."""
    if name.endswith(_COLUMN):
        return 0
    if name.endswith(_ROW):
        return 1
    return None


def _fused(name: str) -> bool:
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def shard_tensor(name: str, t: torch.Tensor, tp: int, m: int
                 ) -> torch.Tensor:
    """Model rank m's part of the whole tensor `name` (views where the
    part is one slice; the fused qkv's three slices are concatenated)."""
    dim = tp_dim(name)
    if tp == 1 or dim is None:
        return t
    if t.shape[dim] % (3 * tp if _fused(name) else tp):
        raise ValueError(f"{name}: axis {dim} of {tuple(t.shape)} does not "
                         f"split over model_parallel={tp}")
    if _fused(name):
        return torch.cat([third.chunk(tp, 0)[m] for third in t.chunk(3, 0)])
    return t.chunk(tp, dim)[m]


def unshard_tensor(name: str, parts) -> torch.Tensor:
    """The whole tensor from every model rank's part, by rank (the inverse
    of `shard_tensor`); a replicated tensor is rank 0's."""
    dim = tp_dim(name)
    if len(parts) == 1 or dim is None:
        return parts[0]
    if _fused(name):
        thirds = [p.chunk(3, 0) for p in parts]
        return torch.cat([thirds[m][j] for j in range(3)
                          for m in range(len(parts))])
    return torch.cat(list(parts), dim)


def layer_of(name: str, stack: str = STACK) -> Optional[Tuple[int, str]]:
    """(layer index, name inside the block) of a parameter of the DiT stack
    whose names start with `stack` ("" for a bare DiTStack), else None."""
    if not name.startswith(stack):
        return None
    head, _, rest = name[len(stack):].partition(".")
    return (int(head), rest) if head.isdigit() and rest else None


def is_sharded(name: str, tp: int, pp: int, stack: str = STACK) -> bool:
    """Whether ranks of the model or pipe axis hold different parts of
    `name` (its gradient norm is then summed over them)."""
    return ((tp > 1 and tp_dim(name) is not None)
            or (pp > 1 and layer_of(name, stack) is not None))


def _layers(names, stack: str) -> int:
    idx = [lay[0] for lay in map(lambda n: layer_of(n, stack), names) if lay]
    return max(idx) + 1 if idx else 0


def shard_state_dict(full: Dict[str, torch.Tensor], tp: int = 1, m: int = 0,
                     pp: int = 1, p: int = 0, stack: str = STACK
                     ) -> Dict[str, torch.Tensor]:
    """The state dict of model rank m on pipe stage p, in its own module's
    names, from a whole one."""
    per = _layers(full, stack) // pp
    if pp > 1 and per * pp != _layers(full, stack):
        raise ValueError(f"{_layers(full, stack)} layers do not split over "
                         f"pipe_parallel={pp}")
    out = {}
    for name, t in full.items():
        lay = layer_of(name, stack) if pp > 1 else None
        if lay is not None:
            i, rest = lay
            if not p * per <= i < (p + 1) * per:
                continue
            local = f"{stack}{i - p * per}.{rest}"
        else:
            local = name
        out[local] = shard_tensor(name, t, tp, m)
    return out


def unshard_state_dicts(parts: Dict[Tuple[int, int], Dict[str, torch.Tensor]],
                        stack: str = STACK) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's, keyed (pipe stage, model
    rank): the inverse of `shard_state_dict`."""
    pp = 1 + max(p for p, _ in parts)
    tp = 1 + max(m for _, m in parts)
    first = parts[(0, 0)]
    per = _layers(first, stack)
    out = {}
    for name in first:
        lay = layer_of(name, stack) if pp > 1 else None
        for p in range(pp if lay else 1):
            whole = (f"{stack}{p * per + lay[0]}.{lay[1]}" if lay else name)
            out[whole] = unshard_tensor(name, [parts[(p, m)][name]
                                               for m in range(tp)])
    return out


def shard_for_mesh(full: Dict[str, torch.Tensor], mesh,
                   stack: str = STACK) -> Dict[str, torch.Tensor]:
    """`shard_state_dict` at this rank's place in `mesh` (a
    parallel/mesh.py::Mesh, or None for one rank)."""
    if mesh is None:
        return dict(full)
    return shard_state_dict(full, mesh.tp, mesh.model_rank, mesh.pp,
                            mesh.pipe_rank, stack)


def gather_state_dict(local: Dict[str, torch.Tensor], mesh,
                      stack: str = STACK) -> Dict[str, torch.Tensor]:
    """The whole state dict on every rank from each rank's `local` (a
    collective over the model and pipe axes: every rank calls it, with the
    same names)."""
    if mesh is None or (mesh.tp == 1 and mesh.pp == 1):
        return dict(local)
    out, per = {}, _layers(local, stack)
    for name in sorted(local):
        t = local[name].detach().contiguous()
        whole = unshard_tensor(name, list(mesh.gather_parts(t, "model")))
        lay = layer_of(name, stack) if mesh.pp > 1 else None
        if lay is None:
            out[name] = whole
            continue
        for p, part in enumerate(mesh.gather_parts(whole, "pipe")):
            out[f"{stack}{p * per + lay[0]}.{lay[1]}"] = part
    return out
