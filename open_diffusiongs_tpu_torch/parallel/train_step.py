"""Train step: optimizer, gradient clipping, accumulation, EMA, and the
gradient reduction of data, sequence and ZeRO-1 parallelism.

Counterpart of open_diffusiongs_tpu/parallel/train_step.py.  The reference
trains with AdamW (lr 1e-5, betas (0.9, 0.99)), CosineAnnealingLR (T_max
500k, eta_min 1e-6), gradient_clip_val 0.5 and EMA decay 0.9999
(configs/diffusionGS_rel.yaml).  One step is: loss -> backward -> (reduce)
-> clip -> update -> EMA of the new params.

`Optimizer` reproduces the JAX package's optax chain
MultiSteps(chain(clip_by_global_norm, adamw | adam | sgd)), where torch's
own classes differ from it:
  * clipping scales by max/norm only when norm >= max, with the norm
    itself (torch's clip_grad_norm_ divides by norm + 1e-6); the gradients
    are multiplied in place by clip / norm (.grad, or the accumulator),
    where optax divides by the norm and then multiplies by the clip, so
    the two agree within test_optimizer_matches_optax_chain's atol 1e-7
    and not bit for bit;
  * the learning rate is the schedule at the count of updates already
    applied (0 on the first update);
  * AdamW decays the weights inside the update, lr * (m̂/(√v̂ + eps) + wd·p),
    with weight_decay 0.01 unless the config says otherwise;
  * with accumulate_grad_batches = k, the k micro-gradients are averaged
    (optax MultiSteps' running mean), one update is applied every k-th
    step and the schedule count advances per applied update;
  * per-prefix param groups (`OptimizerConfig.params`): longest prefix
    wins, prefixes may use dots or slashes.
Updates are in place (torch idiom); the JAX train step returns new
arrays instead.

Several ranks (a parallel/mesh.py::Mesh with world > 1): the model is not
wrapped in DistributedDataParallel (its `module.` prefix would rename the
state-dict keys, and the seq axis' rule below needs the whole world).  At
the step that applies an update (the last micro-step under accumulation:
one reduction per update, of the same mean), each param group's gradient
is flattened into f32 buckets and averaged over the dp·sp ranks of this
rank's replica group (the ranks holding the same tensor- and
pipeline-parallel shard, parallel/mesh.py) with one all-reduce each; with
seq ranks this gives the one-rank gradient, because the DiT's final
gather sums the seq ranks' identical cotangents (parallel/ring.py).  A
group has one bucket of the parameters replicated over `model` and
`pipe`, and, under tensor or pipeline parallelism, one of those sharded
over them (parallel/shard.py::is_sharded).  The clip norm is then taken
over each bucket's dp equal shards, each shard's sum of squares first and
those in rank order, which is exactly what ZeRO-1 computes; the sharded
buckets' partial sums are then summed over `model` and `pipe` (in rank
order), the replicated ones counted once, so the norm is the one-rank
model's.

`Zero1Optimizer` (trainer.zero1 with dp > 1; JAX's `_zero1_spec`,
mesh.py:115-165, which shards opt_state and ema_params over `data`):
each bucket is summed over the seq ranks, reduce-scattered over the data
ranks into this rank's shard and averaged; the Adam moments and the EMA
live only as shards; the clip norm is the all-gathered sum of the
shards' squares (the sharded buckets' summed over `model` and `pipe` as
above); each rank updates its shard of the params and all-gathers them.
Every operation on an element is the one DDP applies to it, so with
dp = 2 the params, EMA and moments equal DDP's bit for bit (a + b =
b + a); under tensor parallelism too, since the norm's sum over
`model` is the one DDP makes.  `state_dict()` gathers the shards into
this rank's tensors by name (a collective: every rank calls it) and
`load_state_dict` keeps this rank's shard; utils/checkpoint.py gathers
those over `model` and `pipe` into the one-rank layout, so checkpoints
move across layouts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..utils.schedules import cosine_annealing_lr
from .shard import is_sharded


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "AdamW"
    lr: float = 1e-5
    betas: tuple = (0.9, 0.99)
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 0.5
    # a plain name ("CosineAnnealingLR" / "constant") using t_max/eta_min,
    # or a recursive spec {"name", "args", "schedulers", "milestones"}
    # mirroring the reference's parse_scheduler (utils/scheduler.py:55-104)
    scheduler: Any = "CosineAnnealingLR"
    t_max: int = 500_000
    eta_min: float = 1e-6
    accumulate_grad_batches: int = 1
    # per-module param groups (utils/scheduler.py:34-41): parameter-name
    # prefix -> overrides such as {"lr": ...}; longest prefix wins
    params: Any = None


def parse_schedule(spec: Any, base_lr: float, t_max: int = 500_000,
                   eta_min: float = 0.0) -> Callable[[int], float]:
    """torch lr_scheduler surface -> schedule fn of the update count.

    SequentialLR switches sub-schedules at `milestones` (each sees a count
    restarted at its milestone, like torch); ChainedScheduler multiplies
    the sub-schedules' factors.  Leaf names: CosineAnnealingLR, LinearLR,
    ConstantLR, ExponentialLR, StepLR, MultiStepLR (and "constant")."""
    if spec is None or spec in ("", "constant"):
        return lambda step: float(base_lr)
    if isinstance(spec, str):
        spec = {"name": spec}
    name = spec.get("name", "constant")
    args = dict(spec.get("args", {}))

    if name in ("SequentialLR", "Sequential"):
        subs = [parse_schedule(s, base_lr, t_max, eta_min)
                for s in spec["schedulers"]]
        bounds = [float(m) for m in spec["milestones"]]
        if len(bounds) != len(subs) - 1:
            raise ValueError("SequentialLR needs len(schedulers)-1 "
                             "milestones")
        starts = [0.0] + bounds

        def seq(step):
            idx = sum(float(step) >= b for b in bounds)
            return subs[idx](float(step) - starts[idx])
        return seq

    if name == "ChainedScheduler":
        subs = [parse_schedule(s, base_lr, t_max, eta_min)
                for s in spec["schedulers"]]

        def chained(step):
            factor = 1.0
            for s in subs:
                factor *= s(step) / base_lr
            return base_lr * factor
        return chained

    if name == "CosineAnnealingLR":
        return cosine_annealing_lr(base_lr, int(args.get("T_max", t_max)),
                                   float(args.get("eta_min", eta_min)))
    if name == "LinearLR":
        sf = float(args.get("start_factor", 1.0 / 3.0))
        ef = float(args.get("end_factor", 1.0))
        total = float(args.get("total_iters", 5))
        return lambda step: base_lr * (
            sf + (ef - sf) * min(max(float(step) / total, 0.0), 1.0))
    if name == "ConstantLR":
        f = float(args.get("factor", 1.0 / 3.0))
        total = float(args.get("total_iters", 5))
        return lambda step: base_lr * (f if float(step) < total else 1.0)
    if name == "ExponentialLR":
        g = float(args["gamma"])
        return lambda step: base_lr * g ** float(step)
    if name == "StepLR":
        size = float(args["step_size"])
        g = float(args.get("gamma", 0.1))
        return lambda step: base_lr * g ** math.floor(float(step) / size)
    if name == "MultiStepLR":
        ms = [float(m) for m in args["milestones"]]
        g = float(args.get("gamma", 0.1))
        return lambda step: base_lr * g ** sum(float(step) >= m for m in ms)
    raise ValueError(f"unknown scheduler {name!r}")


def _f32(x: float) -> float:
    """x rounded to float32 (optax forms its scalars in f32)."""
    return float(torch.tensor(x, dtype=torch.float32))


@dataclasses.dataclass
class _Group:
    params: List[torch.Tensor]
    lr: Callable[[int], float]
    cfg: OptimizerConfig


@dataclasses.dataclass
class _Bucket:
    """The params of one group that are sharded over `model` / `pipe`, or
    of those replicated there, and their flat layout."""
    group: _Group
    params: List[torch.Tensor]
    sharded: bool
    flat: "_Flat"


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class _Flat:
    """One param group's gradient bucket: its tensors flattened in order
    into one f32 vector, zero-padded to dp equal shards of a multiple of
    128 elements (so every shard starts as aligned as a fresh tensor, and a
    reduction over a shard runs as it runs over ZeRO-1's own copy)."""

    ALIGN = 128

    def __init__(self, params: List[torch.Tensor], dp: int):
        for p in params:
            if p.dtype != torch.float32:
                raise TypeError(f"gradient buckets take f32 params, got "
                                f"{p.dtype}")
        self.shapes = [p.shape for p in params]
        self.numels = [p.numel() for p in params]
        self.n = sum(self.numels)
        per = -(-self.n // dp)
        self.shard_len = -(-per // self.ALIGN) * self.ALIGN
        self.total = self.shard_len * dp

    def flatten(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        out = torch.zeros(self.total, dtype=torch.float32,
                          device=tensors[0].device)
        for view, t in zip(self.views(out), tensors):
            view.copy_(t.detach())
        return out

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        out, off = [], 0
        for shape, n in zip(self.shapes, self.numels):
            out.append(flat[off:off + n].view(shape))
            off += n
        return out

    def shard(self, flat: torch.Tensor, r: int) -> torch.Tensor:
        return flat[r * self.shard_len:(r + 1) * self.shard_len]

    def shard_of(self, tensors: List[torch.Tensor], r: int,
                 device=None) -> torch.Tensor:
        """`shard(flatten(tensors), r)` as a new tensor on `device` (the
        tensors' own by default), copied from the parts of `tensors` that
        fall in shard r only: no whole flat copy."""
        lo, hi = r * self.shard_len, (r + 1) * self.shard_len
        out = torch.zeros(self.shard_len, dtype=torch.float32,
                          device=device or tensors[0].device)
        off = 0
        for t, n in zip(tensors, self.numels):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                out[a - lo:b - lo].copy_(
                    t.detach().reshape(-1)[a - off:b - off])
            off += n
        return out


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x)


def _clip_scale(norm: torch.Tensor, clip: float) -> torch.Tensor:
    return torch.where(norm < clip, 1.0, clip / norm)


class Optimizer:
    """The optax-semantics optimizer over named parameters (module
    docstring).  `step()` reads each parameter's .grad (None = zeros) and
    returns whether an update was applied.  With a `mesh` of several ranks
    it averages the gradient over them first (DDP) and keeps the norm it
    clipped with in `grad_norm`."""

    KINDS = {"AdamW": "adamw", "FusedAdam": "adamw", "Adam": "adam",
             "Adan": "adam", "SGD": "sgd"}

    def __init__(self, cfg: OptimizerConfig,
                 named_params: Iterable[Tuple[str, torch.Tensor]],
                 mesh=None):
        if cfg.name not in self.KINDS:
            raise ValueError(f"unknown optimizer {cfg.name}")
        self.cfg = cfg
        self.kind = self.KINDS[cfg.name]
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        gcfgs = {"__default__": cfg}
        for gname, overrides in dict(cfg.params or {}).items():
            o = dict(overrides or {})
            gcfgs[gname] = dataclasses.replace(
                cfg, params=None, lr=float(o.pop("lr", cfg.lr)),
                betas=tuple(o.pop("betas", cfg.betas)),
                eps=float(o.pop("eps", cfg.eps)),
                weight_decay=float(o.pop("weight_decay", cfg.weight_decay)))
        members: Dict[str, list] = {g: [] for g in gcfgs}
        for name, p in named:
            members[self._label(name, gcfgs)].append(p)
        self.groups = [
            _Group(members[g], parse_schedule(c.scheduler, c.lr, c.t_max,
                                              c.eta_min), c)
            for g, c in gcfgs.items() if members[g]]
        self.count = 0          # updates applied (the schedule's count)
        self.mini_step = 0
        self._mu: Dict[int, torch.Tensor] = {}
        self._nu: Dict[int, torch.Tensor] = {}
        self._acc: Optional[List[torch.Tensor]] = None
        # several ranks: each group's buckets (replicated / sharded params),
        # their layouts sharded over dp
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.grad_norm: Optional[torch.Tensor] = None
        self.buckets: List[_Bucket] = []
        if self.mesh is not None:
            name_of = {id(p): n for n, p in named}
            for g in self.groups:
                for sharded in (False, True):
                    ps = [p for p in g.params
                          if is_sharded(name_of[id(p)], self.mesh.tp,
                                        self.mesh.pp) == sharded]
                    if ps:
                        self.buckets.append(_Bucket(g, ps, sharded,
                                                    _Flat(ps, self.mesh.dp)))

    @staticmethod
    def _label(name: str, gcfgs: Dict[str, OptimizerConfig]) -> str:
        path = name.replace(".", "/")
        best, best_len = "__default__", -1
        for gname in gcfgs:
            if gname == "__default__":
                continue
            pref = gname.replace(".", "/")
            if ((path == pref or path.startswith(pref + "/")
                 or ("/" + pref + "/") in ("/" + path + "/"))
                    and len(pref) > best_len):
                best, best_len = gname, len(pref)
        return best

    def state_dict(self) -> Dict[str, Any]:
        """The update count, the accumulation position and the Adam
        moments / gradient accumulator by parameter name (tensors are
        the optimizer's own, not copies; under several ranks a
        mid-accumulation accumulator is averaged over them, which is
        exact: the reduction is linear)."""
        def by_name(store):
            return {n: store[id(p)] for n, p in zip(self.names, self.params)
                    if id(p) in store}
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": by_name(self._mu), "nu": by_name(self._nu),
                "acc": self._acc_state()}

    def _acc_state(self):
        if self._acc is None:
            return None
        acc = self._acc
        if self.mesh is not None:
            acc = [self.mesh.all_reduce_(a.clone(), "replica")
                   .div_(self.mesh.replicas) for a in acc]
        return dict(zip(self.names, acc))

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s output; tensors are copied onto each
        parameter's device."""
        index = dict(zip(self.names, self.params))
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        self._mu = {id(index[n]): t.to(index[n].device, copy=True)
                    for n, t in sd["mu"].items()}
        self._nu = {id(index[n]): t.to(index[n].device, copy=True)
                    for n, t in sd["nu"].items()}
        self._load_acc(sd["acc"])

    def _load_acc(self, acc) -> None:
        self._acc = (None if acc is None else
                     [acc[n].to(p.device, copy=True)
                      for n, p in zip(self.names, self.params)])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def lr(self) -> float:
        """The default group's learning rate for the next update."""
        return self.groups[0].lr(self.count)

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> bool:
        """`grad_norm`: the global norm of the current .grads, when the
        caller has it already (reused for clipping without accumulation
        on one rank; several ranks clip with the reduced gradient's)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        k = self.cfg.accumulate_grad_batches
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = float(self.mini_step + 1)
            for acc, g in zip(self._acc, grads):       # running mean
                acc.add_((g - acc) / n)
            self.mini_step += 1
            if self.mini_step < k:
                if self.mesh is not None:   # this micro-step's own norm
                    self.grad_norm = global_norm(grads)
                return False
            grads, grad_norm = self._acc, None
        index = {id(p): i for i, p in enumerate(self.params)}
        if self.mesh is None:
            clip = self.cfg.grad_clip
            if clip and clip > 0:
                norm = global_norm(grads) if grad_norm is None else grad_norm
                # in place and on the device: no host sync, no second copy
                torch._foreach_mul_(grads, _clip_scale(norm, clip))
            for group in self.groups:
                self._update(group, group.params,
                             [grads[index[id(p)]] for p in group.params])
        else:
            self._step_ranks([[grads[index[id(p)]] for p in b.params]
                              for b in self.buckets])
        self.count += 1
        if k > 1:
            self.mini_step = 0
            for acc in self._acc:
                acc.zero_()
        return True

    def _norm(self, partials: torch.Tensor) -> torch.Tensor:
        """The global norm from each bucket's dp shard partials [dp,
        buckets]: the sharded buckets' columns summed over `model` and
        `pipe` (rank order), the replicated ones counted once."""
        sharded = [b.sharded for b in self.buckets]
        if any(sharded):
            whole = partials
            for axis in ("model", "pipe"):
                if self.mesh.size(axis) > 1:
                    whole = self.mesh.ordered_sum(whole, axis)
            partials = torch.where(
                torch.tensor(sharded, device=partials.device), whole,
                partials)
        return torch.sqrt(partials.sum())

    def _step_ranks(self, by_bucket: List[List[torch.Tensor]]) -> None:
        """DDP: average each bucket over the replica group, clip with the
        sharded norm, update every param (replicated moments)."""
        mesh = self.mesh
        flats = []
        for b, g in zip(self.buckets, by_bucket):
            flat = mesh.all_reduce_(b.flat.flatten(g), "replica")
            flats.append(flat.div_(mesh.replicas))
        partials = torch.stack([
            torch.stack([_sum_sq(b.flat.shard(f, r))
                         for b, f in zip(self.buckets, flats)])
            for r in range(mesh.dp)])                      # [dp, buckets]
        self.grad_norm = self._norm(partials)
        clip = self.cfg.grad_clip
        for b, flat in zip(self.buckets, flats):
            if clip and clip > 0:
                flat.mul_(_clip_scale(self.grad_norm, clip))
            self._update(b.group, b.params, b.flat.views(flat))

    def _update(self, group: _Group, params: List[torch.Tensor],
                grads: List[torch.Tensor]) -> None:
        mu = nu = None
        if self.kind != "sgd":
            mu = [self._mu.setdefault(id(p), torch.zeros_like(p))
                  for p in params]
            nu = [self._nu.setdefault(id(p), torch.zeros_like(p))
                  for p in params]
        self._apply(group, params, grads, mu, nu)

    def _apply(self, group: _Group, params, grads, mu, nu) -> None:
        """One update of `params` (lists of tensors, elementwise)."""
        neg_lr = -group.lr(self.count)
        if self.kind == "sgd":
            torch._foreach_add_(params, torch._foreach_mul(grads, neg_lr))
            return
        c = group.cfg
        b1, b2 = c.betas
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        t = self.count + 1
        bc1 = 1.0 - _f32(_f32(b1) ** t)
        bc2 = 1.0 - _f32(_f32(b2) ** t)
        upd = torch._foreach_div(mu, _f32(bc1))                 # m̂
        den = torch._foreach_sqrt(torch._foreach_div(nu, _f32(bc2)))
        torch._foreach_add_(den, c.eps)
        torch._foreach_div_(upd, den)
        if self.kind == "adamw":
            torch._foreach_add_(upd, torch._foreach_mul(params,
                                                        c.weight_decay))
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(params, upd)


class Zero1Optimizer(Optimizer):
    """ZeRO-1 over the data ranks of `mesh` (module docstring): the Adam
    moments are this rank's flat shard per param group (`_mu_s`, `_nu_s`,
    created at the first update as the one-rank moments are), the params
    stay whole on every rank."""

    def __init__(self, cfg: OptimizerConfig,
                 named_params: Iterable[Tuple[str, torch.Tensor]], mesh):
        if mesh is None or mesh.dp < 2:
            raise ValueError("ZeRO-1 shards over two or more data ranks")
        super().__init__(cfg, named_params, mesh)
        self._mu_s: Optional[List[torch.Tensor]] = None
        self._nu_s: Optional[List[torch.Tensor]] = None

    def param_shards(self) -> List[torch.Tensor]:
        """This rank's shard of each bucket's params, flat f32 copies."""
        r = self.mesh.data_rank
        return [b.flat.shard_of(b.params, r) for b in self.buckets]

    def gather_named(self, shards: List[torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Per-bucket shards -> {name: this rank's tensor} (a collective
        over the data ranks)."""
        by_id = {}
        for b, sh in zip(self.buckets, shards):
            full = self.mesh.all_gather(sh, "data")
            for p, v in zip(b.params, b.flat.views(full)):
                by_id[id(p)] = v.clone()
        return {n: by_id[id(p)] for n, p in zip(self.names, self.params)}

    def shards_from_named(self, named: Dict[str, torch.Tensor]
                          ) -> List[torch.Tensor]:
        """{name: this rank's tensor} -> this rank's per-bucket shards."""
        index = dict(zip(self.names, self.params))
        pos = {id(p): n for n, p in index.items()}
        r = self.mesh.data_rank
        return [b.flat.shard_of([named[pos[id(p)]] for p in b.params], r,
                                device=b.params[0].device)
                for b in self.buckets]

    def state_dict(self) -> Dict[str, Any]:
        """As `Optimizer.state_dict`, the moment shards gathered into whole
        tensors by name (a collective)."""
        moments = {}
        for key, shards in (("mu", self._mu_s), ("nu", self._nu_s)):
            moments[key] = {} if shards is None else self.gather_named(shards)
        return {"count": self.count, "mini_step": self.mini_step,
                **moments, "acc": self._acc_state()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        self._mu_s = (self.shards_from_named(sd["mu"]) if sd["mu"]
                      else None)
        self._nu_s = (self.shards_from_named(sd["nu"]) if sd["nu"]
                      else None)
        self._load_acc(sd["acc"])

    def _step_ranks(self, by_bucket: List[List[torch.Tensor]]) -> None:
        mesh, r = self.mesh, self.mesh.data_rank
        shards = []
        for b, g in zip(self.buckets, by_bucket):
            flat = mesh.all_reduce_(b.flat.flatten(g), "seq")
            shards.append(mesh.reduce_scatter(flat, "data")
                          .div_(mesh.replicas))
        mine = torch.stack([_sum_sq(sh) for sh in shards])
        partials = mesh.all_gather(mine[None], "data")     # [dp, buckets]
        self.grad_norm = self._norm(partials)
        clip = self.cfg.grad_clip
        if self.kind != "sgd" and self._mu_s is None:
            self._mu_s = [torch.zeros_like(sh) for sh in shards]
            self._nu_s = [torch.zeros_like(sh) for sh in shards]
        for i, (b, sh) in enumerate(zip(self.buckets, shards)):
            if clip and clip > 0:
                sh.mul_(_clip_scale(self.grad_norm, clip))
            p_sh = b.flat.shard_of(b.params, r)
            mu = nu = None
            if self.kind != "sgd":
                mu, nu = [self._mu_s[i]], [self._nu_s[i]]
            self._apply(b.group, [p_sh], [sh], mu, nu)
            full = mesh.all_gather(p_sh, "data")
            for p, v in zip(b.params, b.flat.views(full)):
                p.copy_(v)


def make_optimizer(cfg: OptimizerConfig,
                   named_params: Iterable[Tuple[str, torch.Tensor]],
                   mesh=None, zero1: bool = False) -> Optimizer:
    """Name-based optimizer / scheduler parsing (utils/scheduler.py:34-104)
    over `named_params` (e.g. `model.named_parameters()`).  `mesh`: the
    ranks to average over; `zero1` shards the optimizer state over its
    data ranks when there are two or more (with one it shards nothing, as
    in JAX)."""
    if zero1 and mesh is not None and mesh.dp > 1:
        return Zero1Optimizer(cfg, named_params, mesh)
    return Optimizer(cfg, named_params, mesh)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]   # None: no whole EMA
    # ZeRO-1: this rank's EMA shard per param group (ema_params is None)
    ema_shard: Optional[List[torch.Tensor]] = None

    @property
    def has_ema(self) -> bool:
        return self.ema_params is not None or self.ema_shard is not None

    def full_ema(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA by name, whole (ZeRO-1 shards gathered: a collective)."""
        if self.ema_shard is not None:
            return self.optimizer.gather_named(self.ema_shard)
        return self.ema_params

    @torch.no_grad()
    def load_ema(self, named: Dict[str, torch.Tensor]) -> None:
        """Copy a whole EMA by name in (keeping this rank's shard)."""
        if self.ema_shard is not None:
            self.ema_shard = self.optimizer.shards_from_named(named)
            return
        if set(named) != set(self.ema_params):
            raise KeyError("ema_params: checkpoint keys differ from the "
                           "state's")
        for k, t in self.ema_params.items():
            t.copy_(named[k])


def init_train_state(params: Dict[str, torch.Tensor], optimizer: Optimizer,
                     ema_decay: Optional[float] = 0.9999) -> TrainState:
    if ema_decay and isinstance(optimizer, Zero1Optimizer):
        return TrainState(step=0, params=dict(params), optimizer=optimizer,
                          ema_params=None,
                          ema_shard=optimizer.param_shards())
    ema = ({k: p.detach().clone() for k, p in params.items()}
           if ema_decay else None)
    return TrainState(step=0, params=dict(params), optimizer=optimizer,
                      ema_params=ema)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    ema_decay: Optional[float] = 0.9999):
    """loss_fn(batch, step) -> (loss, metrics).

    Returns `train_step(state, batch) -> (state, metrics)`: loss, backward,
    (reduce over the ranks,) clip + update (`optimizer`), then the EMA of
    the NEW params, e <- e·d + p·(1 - d).  The state is updated in place;
    metrics gain `grad_norm` and stay device tensors (no host sync).  On
    one rank grad_norm is the global norm of this step's raw gradients;
    on several, that of the reduced gradient the update clipped with (of
    this rank's raw micro-gradient at a micro-step without an update).
    Metrics are this rank's: Mesh.mean_metrics averages them."""
    d = _f32(ema_decay) if ema_decay else None

    def train_step(state: TrainState, batch):
        loss, metrics = loss_fn(batch, state.step)
        optimizer.zero_grad()
        loss.backward()
        metrics = dict(metrics)
        if optimizer.mesh is None:
            grads = [p.grad for p in state.params.values()
                     if p.grad is not None]
            metrics["grad_norm"] = global_norm(grads).detach()
            optimizer.step(metrics["grad_norm"])
        else:
            optimizer.step()
            metrics["grad_norm"] = optimizer.grad_norm
        if d is not None and state.has_ema:
            with torch.no_grad():
                if state.ema_shard is not None:
                    ema, new = state.ema_shard, optimizer.param_shards()
                else:
                    ema = list(state.ema_params.values())
                    new = [state.params[k] for k in state.ema_params]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    new, _f32(1.0 - d)))
        state.step += 1
        return state, metrics

    return train_step
