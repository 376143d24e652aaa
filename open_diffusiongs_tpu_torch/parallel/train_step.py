"""Train step on one GPU: optimizer, gradient clipping, accumulation, EMA.

Counterpart of open_diffusiongs_tpu/parallel/train_step.py (without the
mesh: the port trains on one device).  The reference trains with AdamW
(lr 1e-5, betas (0.9, 0.99)), CosineAnnealingLR (T_max 500k, eta_min 1e-6),
gradient_clip_val 0.5 and EMA decay 0.9999 (configs/diffusionGS_rel.yaml).
One step is: loss -> backward -> clip -> update -> EMA of the new params.

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..utils.schedules import cosine_annealing_lr


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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """The optax-semantics optimizer over named parameters (module
    docstring).  `step()` reads each parameter's .grad (None = zeros) and
    returns whether an update was applied."""

    KINDS = {"AdamW": "adamw", "FusedAdam": "adamw", "Adam": "adam",
             "Adan": "adam", "SGD": "sgd"}

    def __init__(self, cfg: OptimizerConfig,
                 named_params: Iterable[Tuple[str, torch.Tensor]]):
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
        the optimizer's own, not copies)."""
        def by_name(store):
            return {n: store[id(p)] for n, p in zip(self.names, self.params)
                    if id(p) in store}
        acc = (None if self._acc is None
               else dict(zip(self.names, self._acc)))
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": by_name(self._mu), "nu": by_name(self._nu),
                "acc": acc}

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
        self._acc = (None if sd["acc"] is None else
                     [sd["acc"][n].to(p.device, copy=True)
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
        caller has it already (reused for clipping without accumulation)."""
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
                return False
            grads, grad_norm = self._acc, None
        clip = self.cfg.grad_clip
        if clip and clip > 0:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            # in place and on the device: no host sync, no second copy
            torch._foreach_mul_(grads, torch.where(norm < clip, 1.0,
                                                   clip / norm))
        index = {id(p): i for i, p in enumerate(self.params)}
        for group in self.groups:
            self._update(group, [grads[index[id(p)]] for p in group.params])
        self.count += 1
        if k > 1:
            self.mini_step = 0
            for acc in self._acc:
                acc.zero_()
        return True

    def _update(self, group: _Group, grads: List[torch.Tensor]) -> None:
        params = group.params
        neg_lr = -group.lr(self.count)
        if self.kind == "sgd":
            torch._foreach_add_(params, torch._foreach_mul(grads, neg_lr))
            return
        c = group.cfg
        b1, b2 = c.betas
        mu = [self._mu.setdefault(id(p), torch.zeros_like(p)) for p in params]
        nu = [self._nu.setdefault(id(p), torch.zeros_like(p)) for p in params]
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


def make_optimizer(cfg: OptimizerConfig,
                   named_params: Iterable[Tuple[str, torch.Tensor]]
                   ) -> Optimizer:
    """Name-based optimizer / scheduler parsing (utils/scheduler.py:34-104)
    over `named_params` (e.g. `model.named_parameters()`)."""
    return Optimizer(cfg, named_params)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]   # None: EMA disabled


def init_train_state(params: Dict[str, torch.Tensor], optimizer: Optimizer,
                     ema_decay: Optional[float] = 0.9999) -> TrainState:
    ema = ({k: p.detach().clone() for k, p in params.items()}
           if ema_decay else None)
    return TrainState(step=0, params=dict(params), optimizer=optimizer,
                      ema_params=ema)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    ema_decay: Optional[float] = 0.9999):
    """loss_fn(batch, step) -> (loss, metrics).

    Returns `train_step(state, batch) -> (state, metrics)`: loss, backward,
    clip + update (`optimizer`), then the EMA of the NEW params,
    e <- e·d + p·(1 - d).  The state is updated in place; metrics gain
    `grad_norm` (the global norm of this step's raw gradients) and stay
    device tensors (no host sync)."""
    d = _f32(ema_decay) if ema_decay else None

    def train_step(state: TrainState, batch):
        loss, metrics = loss_fn(batch, state.step)
        optimizer.zero_grad()
        loss.backward()
        grads = [p.grad for p in state.params.values() if p.grad is not None]
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads).detach()
        optimizer.step(metrics["grad_norm"])
        if state.ema_params is not None and d is not None:
            with torch.no_grad():
                ema = list(state.ema_params.values())
                new = [state.params[k] for k in state.ema_params]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    new, _f32(1.0 - d)))
        state.step += 1
        return state, metrics

    return train_step
