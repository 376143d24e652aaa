"""Data-parallel helpers of the training / evaluation CLI, for one process.

Counterpart of the single-process behaviour of
open_diffusiongs_tpu/parallel/mesh.py (`local_batch_slice`,
`eval_shard_indices`, `allreduce_metric_sums`, :167-197): the port runs
one process on one GPU, so each is the identity there.  DDP across
processes, and the tensor / sequence / pipeline sharding rules and ZeRO-1
of the JAX mesh, are ROADMAP Queue 1 item 6; until then a config that
asks for them raises (`check_parallelism`) instead of being ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

# trainer keys that shard the model or the step across devices in the JAX
# package (launch.py:104-113)
PARALLEL_KEYS = ("model_parallel", "seq_parallel", "pipe_parallel")


def check_parallelism(trainer_cfg: Dict[str, Any], n_data: int = 1) -> None:
    """Raise NotImplementedError, naming the key, for every parallelism the
    port does not have: trainer.model_parallel / seq_parallel /
    pipe_parallel > 1, or trainer.zero1 with more than one data rank
    (with one rank ZeRO-1 shards nothing, as in the JAX package)."""
    cfg = dict(trainer_cfg or {})
    for key in PARALLEL_KEYS:
        if int(cfg.get(key, 1) or 1) > 1:
            raise NotImplementedError(
                f"trainer.{key}={cfg[key]}: the port trains on one GPU; "
                f"model, sequence and pipeline parallelism are not ported "
                f"(ROADMAP Queue 1 item 6)")
    if bool(cfg.get("zero1", False)) and n_data > 1:
        raise NotImplementedError(
            f"trainer.zero1 with {n_data} data ranks: optimizer-state "
            f"sharding is not ported (ROADMAP Queue 1 item 6)")


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of the global batch: all of it."""
    return slice(0, global_batch)


def eval_shard_indices(n_total: int, pid: int = 0, nproc: int = 1) -> list:
    """Round-robin shard of the eval set for process `pid` of `nproc`
    (indices pid, pid + nproc, ...): every index with one process."""
    return list(range(pid, n_total, nproc))


def allreduce_metric_sums(values: Sequence[float]) -> np.ndarray:
    """Sum metric accumulators across processes: the identity for one."""
    return np.asarray(values, np.float64)
