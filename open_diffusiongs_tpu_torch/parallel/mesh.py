"""Process groups of the (data, pipe, seq, model) layout, and the
data-parallel helpers of the training / evaluation CLI.

Counterpart of open_diffusiongs_tpu/parallel/mesh.py.  JAX lays its
devices out as a (data, pipe, seq, model) mesh, the model axis innermost
(:30-48); the port runs one process per rank and lays the ranks out in the
same order: rank = ((d·pp + p)·sp + s)·tp + m.  At pp = tp = 1 that is
d·sp + s.  `init_mesh` builds, from torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, `init_method="env://"`) or from explicit
arguments, one process group per line of each axis:
  * seq: the sp ranks of one (d, p, m), the ring of parallel/ring.py;
  * data: the dp ranks of one (p, s, m), the gradient shards of ZeRO-1,
    the eval shards and the metric sums;
  * model: the tp ranks of one (d, p, s), the collectives of tensor
    parallelism (parallel/tensor_parallel.py);
  * pipe: the pp stages of one (d, s, m), GPipe's neighbours
    (parallel/pipeline.py);
  * replica: the dp·sp ranks of one (p, m), which hold the same parameter
    shard and average their gradients (parallel/train_step.py).
The seq, model and pipe ranks of one data row load and evaluate the same
items.

`local_batch_slice`, `eval_shard_indices` and `allreduce_metric_sums`
(JAX :167-197) work over the data ranks.  `check_parallelism` accepts every
trainer key of parallelism the JAX package accepts, and raises as JAX
asserts: an axis that does not divide the world size, or pipeline
parallelism beside tensor or sequence parallelism (JAX
models/transformer.py:618-622).  Which parameter each rank holds is
parallel/shard.py.

Backends: nccl for CUDA ranks, gloo for CPU ranks, unless the caller names
one.  Ranks that share one card must use gloo (NCCL refuses two ranks on
one device); nccl with more local ranks than cards raises and names the
`--dist-backend` flag.  Nothing switches backend by itself.  Gloo runs
collectives on CUDA tensors but not point-to-point sends, so the ring's
neighbour exchange (`ring_shift`) and the pipeline's sends (`send` /
`recv`) stage CUDA tensors through pinned host buffers when the group's
backend is gloo (counted in `STAGED`); the compute stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "pipe", "seq", "model")
STAGED = 0   # point-to-point transfers that went through pinned host buffers


def check_parallelism(trainer_cfg: Dict[str, Any], world_size: int = 1
                      ) -> tuple:
    """(dp, pp, sp, tp) of a run of `world_size` ranks from
    trainer.pipe_parallel / seq_parallel / model_parallel (1 when unset).
    Raises ValueError for an axis, or a product of axes, that does not
    divide the world size (JAX make_mesh's assertion) and for
    pipe_parallel > 1 beside seq_parallel or model_parallel > 1 (JAX's
    message).  trainer.zero1 is accepted at any dp (with one data rank it
    shards nothing)."""
    cfg = dict(trainer_cfg or {})
    sizes = {}
    for key in ("pipe_parallel", "seq_parallel", "model_parallel"):
        n = int(cfg.get(key, 1) or 1)
        if n < 1 or world_size % n:
            raise ValueError(f"trainer.{key}={n} does not divide the world "
                             f"size {world_size}")
        sizes[key] = n
    pp, sp, tp = (sizes[k] for k in ("pipe_parallel", "seq_parallel",
                                     "model_parallel"))
    if world_size % (pp * sp * tp):
        raise ValueError(f"pipe_parallel x seq_parallel x model_parallel = "
                         f"{pp * sp * tp} does not divide the world size "
                         f"{world_size}")
    if pp > 1 and (sp > 1 or tp > 1):
        raise ValueError("pipeline parallelism composes with dp only "
                         "(tp/sp shard_map nesting not supported)")
    return world_size // (pp * sp * tp), pp, sp, tp


def axis_groups(world: int, pp: int = 1, sp: int = 1, tp: int = 1
                ) -> Dict[str, List[List[int]]]:
    """Every line of each axis as a list of global ranks, by the axis'
    index: {"data", "pipe", "seq", "model", "replica"} -> groups.  Rank =
    ((d·pp + p)·sp + s)·tp + m; a replica group is one (p, m), its ranks
    in (d, s) order."""
    dp = world // (pp * sp * tp)
    ranks = np.arange(world).reshape(dp, pp, sp, tp)
    out = {axis: np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
           .tolist() for i, axis in enumerate(AXES)}
    out["replica"] = ranks.transpose(1, 3, 0, 2).reshape(pp * tp,
                                                         dp * sp).tolist()
    return out


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device_type: str, local_rank: int, local_world: int,
                backend: Optional[str]) -> torch.device:
    """The device of a rank: the CPU, or card local_rank mod the card count.
    nccl needs a card per local rank; ranks sharing a card take gloo."""
    if device_type != "cuda":
        return torch.device(device_type)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("open_diffusiongs_tpu_torch: no CUDA device is "
                           "available")
    if (backend or "nccl") == "nccl" and local_world > n:
        raise ValueError(
            f"{local_world} local ranks on {n} card(s): NCCL refuses two "
            f"ranks on one device; pass --dist-backend gloo to share a card")
    return torch.device("cuda", local_rank % n)


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, pipe, seq, model) layout and its
    groups.  A one-rank mesh (`Mesh()`) has no process group and every
    collective is the identity.  `groups[axis]` is this rank's process
    group of the axis (None where the axis has size 1, or where the axis
    is the whole world), `ranks[axis]` its global ranks by axis index."""
    world: int = 1
    rank: int = 0
    sp: int = 1
    tp: int = 1
    pp: int = 1
    backend: Optional[str] = None
    device: torch.device = torch.device("cpu")
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ranks: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    @property
    def dp(self) -> int:
        return self.world // (self.pp * self.sp * self.tp)

    @property
    def replicas(self) -> int:
        """Ranks holding the same parameter shard: dp·sp."""
        return self.dp * self.sp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def seq_rank(self) -> int:
        return self.rank // self.tp % self.sp

    @property
    def pipe_rank(self) -> int:
        return self.rank // (self.tp * self.sp) % self.pp

    @property
    def data_rank(self) -> int:
        return self.rank // (self.tp * self.sp * self.pp)

    @property
    def seq_ranks(self) -> tuple:
        return self.ranks.get("seq", (self.rank,))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def leads_row(self) -> bool:
        """The first rank of its data row (seq, pipe and model rank 0):
        the one that writes the row's eval artifacts."""
        return self.seq_rank == 0 and self.pipe_rank == 0 \
            and self.model_rank == 0

    def size(self, axis: str) -> int:
        return {"world": self.world, "data": self.dp, "pipe": self.pp,
                "seq": self.sp, "model": self.tp,
                "replica": self.replicas}[axis]

    def _group(self, axis: str):
        """(process group, size) of 'world' or an axis of `axis_groups`."""
        n = self.size(axis)          # raises KeyError for an unknown axis
        if n == self.world:
            return None, n
        return self.groups.get(axis), n

    def all_reduce_(self, t: torch.Tensor, axis: str = "world",
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place reduction (a sum unless `op` says otherwise) over the
        axis' ranks."""
        group, n = self._group(axis)
        if n > 1:
            dist.all_reduce(t, op=op, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The axis' ranks' tensors concatenated along `dim`, by rank."""
        group, n = self._group(axis)
        if n == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    def gather_parts(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The axis' ranks' tensors stacked on a new leading dim, by
        rank (every rank's `t` has one shape)."""
        return self.all_gather(t[None], axis)

    def ordered_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of the axis' ranks' tensors in f32, added in rank
        order (the same bits on every rank, whatever the backend)."""
        parts = self.gather_parts(t.contiguous(), axis)
        out = parts[0].float()
        for part in parts[1:]:
            out = out + part.float()
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0
                       ) -> torch.Tensor:
        """This rank's block along `dim` of the sum over the axis' ranks."""
        group, n = self._group(axis)
        if n == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out.movedim(0, dim)

    def broadcast_(self, t: torch.Tensor, axis: str, src: int
                   ) -> torch.Tensor:
        """In place: the axis' rank `src` (an index along the axis) sends
        its `t` to every rank of the axis."""
        group, n = self._group(axis)
        if n > 1:
            dist.broadcast(t, src=self.ranks[axis][src], group=group)
        return t

    def ring_shift(self, tensors: Sequence[torch.Tensor]) -> "_Shift":
        """Start sending each tensor to the next seq rank and receiving its
        like from the previous one; `.wait()` returns the received tensors
        on their device.  CUDA tensors go through pinned host buffers when
        the backend is gloo (its point-to-point takes host memory only)."""
        s = self.seq_rank
        nxt = self.seq_ranks[(s + 1) % self.sp]
        prv = self.seq_ranks[(s - 1) % self.sp]
        staged = self._staged(tensors[0])
        if staged:
            send = [_pinned(t).copy_(t) for t in tensors]
            recv = [_pinned(t) for t in tensors]
        else:
            send = [t.contiguous() for t in tensors]
            recv = [torch.empty_like(t) for t in send]
        group = self.groups.get("seq")
        ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in send]
               + [dist.P2POp(dist.irecv, t, prv, group) for t in recv])
        return _Shift(dist.batch_isend_irecv(ops), send, recv,
                      tensors[0].device if staged else None)

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether `t` goes through pinned host memory (a CUDA tensor under
        gloo), counted in STAGED."""
        global STAGED
        staged = self.backend == "gloo" and t.is_cuda
        STAGED += staged
        return staged

    def send(self, t: torch.Tensor, axis: str, dst: int, tag: int
             ) -> "_Shift":
        """Start sending `t` to the axis' rank `dst` (an index along the
        axis), matched by `tag`; `.wait()` before `t` is reused."""
        if self._staged(t):
            buf = _pinned(t).copy_(t)
        else:
            buf = t.contiguous()
        work = dist.isend(buf, self.ranks[axis][dst],
                          group=self.groups.get(axis), tag=tag)
        return _Shift([work], [buf], [], None)

    def recv(self, like: torch.Tensor, axis: str, src: int, tag: int
             ) -> torch.Tensor:
        """A tensor shaped and typed like `like`, on its device, from the
        axis' rank `src`, matched by `tag` (blocks until it arrives)."""
        buf = _pinned(like) if self._staged(like) else torch.empty_like(like)
        dist.recv(buf, self.ranks[axis][src], group=self.groups.get(axis),
                  tag=tag)
        return buf.to(like.device, non_blocking=True)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, float]:
        """Scalar metrics averaged over the data ranks (one collective),
        as host floats."""
        names = sorted(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                           .to(self.device).reshape(()) for k in names])
        self.all_reduce_(vec, "data")
        return dict(zip(names, (vec / self.dp).tolist()))


class _Shift:
    def __init__(self, works, send, recv, device):
        self.works, self.send, self.recv = works, send, recv
        self.device = device

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        if self.device is None:
            return self.recv
        return [t.to(self.device, non_blocking=True) for t in self.recv]


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def init_mesh(seq_parallel: int = 1, device_type: str = "cuda",
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              local_rank: Optional[int] = None,
              local_world: Optional[int] = None,
              model_parallel: int = 1, pipe_parallel: int = 1) -> Mesh:
    """This process's Mesh.  Rank, world size and local rank come from the
    arguments or from torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    LOCAL_WORLD_SIZE (init_method "env://" by default); one rank in all
    builds no process group.  The default group is initialised here
    unless it already is; every rank creates every line's group of every
    axis of size > 1, in one order.  The axes are checked as
    `check_parallelism` checks them."""
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", rank))
    local_world = int(local_world if local_world is not None
                      else env.get("LOCAL_WORLD_SIZE", world))
    _, pp, sp, tp = check_parallelism(
        {"seq_parallel": seq_parallel, "model_parallel": model_parallel,
         "pipe_parallel": pipe_parallel}, world)
    backend = backend or default_backend(torch.device(device_type))
    device = rank_device(device_type, local_rank, local_world, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world == 1:
        return Mesh(device=device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()}, not {backend}")
    mesh = Mesh(world=world, rank=rank, sp=sp, tp=tp, pp=pp,
                backend=backend, device=device)
    for axis, lines in axis_groups(world, pp, sp, tp).items():
        mine = next(ranks for ranks in lines if rank in ranks)
        mesh.ranks[axis] = tuple(mine)
        if 1 < len(mine) < world:
            for ranks in lines:
                g = dist.new_group(ranks, backend=backend)
                if ranks == mine:
                    mesh.groups[axis] = g
    return mesh


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None
                      ) -> slice:
    """This data rank's slice of the global batch (all of it with one)."""
    dp, d = (1, 0) if mesh is None else (mesh.dp, mesh.data_rank)
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"{dp} data ranks")
    per = global_batch // dp
    return slice(d * per, (d + 1) * per)


def eval_shard_indices(n_total: int, pid: Optional[int] = None,
                       nproc: Optional[int] = None,
                       mesh: Optional[Mesh] = None) -> list:
    """Round-robin shard of the eval set for data rank `pid` of `nproc`
    (indices pid, pid + nproc, ...; by default this rank's place in
    `mesh`): every index with one data rank."""
    if pid is None:
        pid = 0 if mesh is None else mesh.data_rank
    if nproc is None:
        nproc = 1 if mesh is None else mesh.dp
    return list(range(pid, n_total, nproc))


def allreduce_metric_sums(values: Sequence[float],
                          mesh: Optional[Mesh] = None) -> np.ndarray:
    """Sum metric accumulators over the data ranks (the identity for
    one).  Every rank must call it the same number of times."""
    arr = np.asarray(values, np.float64)
    if mesh is None or mesh.dp == 1:
        return arr
    t = torch.as_tensor(arr, dtype=torch.float64, device=mesh.device)
    return mesh.all_reduce_(t, "data").cpu().numpy()
