"""Process groups of the data and seq axes, and the data-parallel helpers of
the training / evaluation CLI.

Counterpart of open_diffusiongs_tpu/parallel/mesh.py.  JAX lays its
devices out as a (data, pipe, seq, model) mesh (:30-48); the port runs one
process per rank and lays the ranks out as (data, seq), the seq axis
inner: rank = d·sp + s.  `init_mesh` builds, from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, `init_method="env://"`) or from explicit
arguments, one process group per data row (its sp ranks: the ring of
parallel/ring.py) and one per seq column (its dp ranks: the gradient
shards of ZeRO-1, the eval shards and the metric sums).  The seq ranks of
one data row load and evaluate the same items.

`local_batch_slice`, `eval_shard_indices` and `allreduce_metric_sums`
(JAX :167-197) work over the data ranks.  Tensor and pipeline parallelism
are still to port (ROADMAP Queue 1 item 6): a config that asks for them
raises (`check_parallelism`) instead of being ignored.

Backends: nccl for CUDA ranks, gloo for CPU ranks, unless the caller names
one.  Ranks that share one card must use gloo (NCCL refuses two ranks on
one device); nccl with more local ranks than cards raises and names the
`--dist-backend` flag.  Nothing switches backend by itself.  Gloo runs
collectives on CUDA tensors but not point-to-point sends, so the ring's
neighbour exchange (`ring_shift`) stages CUDA tensors through pinned host
buffers when the group's backend is gloo (counted in `STAGED`); the
compute stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# trainer keys of parallelism the port does not have yet (launch.py:104-113)
NOT_PORTED = ("model_parallel", "pipe_parallel")
STAGED = 0   # ring_shift calls that went through pinned host buffers


def check_parallelism(trainer_cfg: Dict[str, Any], world_size: int = 1
                      ) -> tuple:
    """(dp, sp) of a run of `world_size` ranks: trainer.seq_parallel ranks
    in a ring per data row, world_size // sp data rows.  Raises
    NotImplementedError, naming the key, for trainer.model_parallel /
    pipe_parallel > 1, and ValueError for a seq_parallel that does not
    divide the world size (JAX make_mesh's assertion).  trainer.zero1 is
    accepted at any dp (with one data rank it shards nothing)."""
    cfg = dict(trainer_cfg or {})
    for key in NOT_PORTED:
        if int(cfg.get(key, 1) or 1) > 1:
            raise NotImplementedError(
                f"trainer.{key}={cfg[key]}: tensor and pipeline parallelism "
                f"are not ported (ROADMAP Queue 1 item 6)")
    sp = int(cfg.get("seq_parallel", 1) or 1)
    if sp < 1 or world_size % sp:
        raise ValueError(f"trainer.seq_parallel={sp} does not divide the "
                         f"world size {world_size}")
    return world_size // sp, sp


def rank_layout(world: int, sp: int) -> tuple:
    """(data rows, seq columns) as lists of global ranks: row d holds the
    ranks d·sp .. d·sp + sp - 1 (one ring), column s the ranks s, sp + s,
    ... (one rank per data row)."""
    dp = world // sp
    rows = [[d * sp + s for s in range(sp)] for d in range(dp)]
    cols = [[d * sp + s for d in range(dp)] for s in range(sp)]
    return rows, cols


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
    """This rank's place in the (data, seq) layout and its groups.  A
    one-rank mesh (`Mesh()`) has no process group and every collective is
    the identity."""
    world: int = 1
    rank: int = 0
    sp: int = 1
    backend: Optional[str] = None
    device: torch.device = torch.device("cpu")
    data_group: Any = None    # the dp ranks of this rank's seq column
    seq_group: Any = None     # the sp ranks of this rank's data row
    seq_ranks: tuple = (0,)   # global ranks of the row, by seq index
    data_ranks: tuple = (0,)  # global ranks of the column, by data index

    @property
    def dp(self) -> int:
        return self.world // self.sp

    @property
    def data_rank(self) -> int:
        return self.rank // self.sp

    @property
    def seq_rank(self) -> int:
        return self.rank % self.sp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _group(self, axis: str):
        """(process group, size) of 'world', 'data' or 'seq'."""
        if axis == "world":
            return None, self.world
        if axis == "data":
            return self.data_group, self.dp
        if axis == "seq":
            return self.seq_group, self.sp
        raise ValueError(f"unknown axis {axis!r}")

    def all_reduce_(self, t: torch.Tensor, axis: str = "world"
                    ) -> torch.Tensor:
        """In-place sum over the axis' ranks."""
        group, n = self._group(axis)
        if n > 1:
            dist.all_reduce(t, group=group)
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

    def ring_shift(self, tensors: Sequence[torch.Tensor]) -> "_Shift":
        """Start sending each tensor to the next seq rank and receiving its
        like from the previous one; `.wait()` returns the received tensors
        on their device.  CUDA tensors go through pinned host buffers when
        the backend is gloo (its point-to-point takes host memory only)."""
        global STAGED
        s = self.seq_rank
        nxt = self.seq_ranks[(s + 1) % self.sp]
        prv = self.seq_ranks[(s - 1) % self.sp]
        staged = self.backend == "gloo" and tensors[0].is_cuda
        if staged:
            STAGED += 1
            send = [_pinned(t).copy_(t) for t in tensors]
            recv = [_pinned(t) for t in tensors]
        else:
            send = [t.contiguous() for t in tensors]
            recv = [torch.empty_like(t) for t in send]
        ops = ([dist.P2POp(dist.isend, t, nxt, self.seq_group) for t in send]
               + [dist.P2POp(dist.irecv, t, prv, self.seq_group)
                  for t in recv])
        return _Shift(dist.batch_isend_irecv(ops), send, recv,
                      tensors[0].device if staged else None)

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
        self.works, self.send, self.recv, self.device = works, send, recv, device

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
              local_world: Optional[int] = None) -> Mesh:
    """This process's Mesh.  Rank, world size and local rank come from the
    arguments or from torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    LOCAL_WORLD_SIZE (init_method "env://" by default); one rank in all
    builds no process group.  The default group is initialised here
    unless it already is; every rank creates every data row's and seq
    column's group, in one order."""
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", rank))
    local_world = int(local_world if local_world is not None
                      else env.get("LOCAL_WORLD_SIZE", world))
    if world % seq_parallel:
        raise ValueError(f"trainer.seq_parallel={seq_parallel} does not "
                         f"divide the world size {world}")
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
    rows, cols = rank_layout(world, seq_parallel)
    mesh = Mesh(world=world, rank=rank, sp=seq_parallel, backend=backend,
                device=device)
    d, s = mesh.data_rank, mesh.seq_rank
    if seq_parallel > 1:
        for ranks in rows:
            g = dist.new_group(ranks, backend=backend)
            if ranks == rows[d]:
                mesh.seq_group = g
    if world // seq_parallel > 1:
        for ranks in cols:
            g = dist.new_group(ranks, backend=backend)
            if ranks == cols[s]:
                mesh.data_group = g
    mesh.seq_ranks, mesh.data_ranks = tuple(rows[d]), tuple(cols[s])
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
