"""Config system: YAML + CLI-dotlist merge, ${...} resolvers, trial dirs.

The port's own copy of open_diffusiongs_tpu/utils/config.py (the
reference's OmegaConf layer without omegaconf): a small interpolation
engine over PyYAML with the reference's resolver set
(calc_exp_lr_decay_rate, add/sub/mul/div/idiv, basename, rmspace, tuple2,
gt0, cmaxgt0, not, cmaxgt0orcmaxgt0) and `${dotted.path}` references, the
ExperimentConfig schema (unknown top-level keys are refused) and the
`{exp_root_dir}/{name}/{tag+timestamp}` trial-dir layout, so the same
configs/*.yaml drive both packages.

Dotlist values go through `yaml.safe_load`: `1e-6` stays a string and
`1.e-5` becomes a float, as in the JAX package; the builders cast with
`float()`.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional

import yaml

from .schedules import C_max

__all__ = ["C_max", "ExperimentConfig", "dump_config", "from_dotlist",
           "load_config", "merge", "resolve"]

RESOLVERS = {
    "calc_exp_lr_decay_rate": lambda factor, n: factor ** (1.0 / n),
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "idiv": lambda a, b: a // b,
    "basename": lambda p: os.path.basename(p),
    "rmspace": lambda s, sub: str(s).replace(" ", sub),
    "tuple2": lambda s: [float(s), float(s)],
    "gt0": lambda s: s > 0,
    "cmaxgt0": lambda s: C_max(s) > 0,
    "not": lambda s: not s,
    "cmaxgt0orcmaxgt0": lambda a, b: C_max(a) > 0 or C_max(b) > 0,
}

_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _lookup(root: Dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            cur = cur[part]
    return cur


def _resolve_expr(expr: str, root: Dict):
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in RESOLVERS:
            args = [_resolve_value(a.strip(), root)
                    for a in argstr.split(",")] if argstr.strip() else []
            return RESOLVERS[name](*args)
    return _lookup(root, expr)


def _resolve_value(token: str, root: Dict):
    """A resolver argument: nested ${...}, dotted ref, or literal."""
    if token.startswith("${") and token.endswith("}"):
        return _resolve_expr(token[2:-1], root)
    try:
        return yaml.safe_load(token)
    except yaml.YAMLError:
        return token


def _resolve_str(s: str, root: Dict):
    # a whole-string interpolation keeps the resolved type; else splice
    m = _INTERP.fullmatch(s.strip())
    if m:
        return _resolve_expr(m.group(1), root)
    return _INTERP.sub(lambda m: str(_resolve_expr(m.group(1), root)), s)


def resolve(node: Any, root: Optional[Dict] = None) -> Any:
    """Recursively resolve ${...} interpolations (multi-pass, like
    OmegaConf.resolve: a reference not yet resolvable waits for the next
    pass)."""
    if root is None:
        for _ in range(8):  # chained references
            new = resolve(node, node)
            if new == node:
                return new
            node = new
        return node
    if isinstance(node, dict):
        return {k: resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [resolve(v, root) for v in node]
    if isinstance(node, str) and "${" in node:
        try:
            return _resolve_str(node, root)
        except (KeyError, IndexError, TypeError):
            return node
    return node


def merge(base: Dict, override: Dict) -> Dict:
    """Deep merge: dicts merge key by key, anything else is replaced."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def from_dotlist(args: List[str]) -> Dict:
    """["a.b=1", "c=[2,3]"] -> nested dict (OmegaConf.from_cli)."""
    out: Dict = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"CLI override must be key=value, got {arg!r}")
        key, _, val = arg.partition("=")
        cur = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = yaml.safe_load(val) if val != "" else None
    return out


@dataclass
class ExperimentConfig:
    """Top-level experiment schema (the reference's utils/config.py:51-101)."""

    name: str = "default"
    description: str = ""
    tag: str = ""
    seed: int = 0
    use_timestamp: bool = True
    timestamp: Optional[str] = None
    exp_root_dir: str = "outputs"

    exp_dir: str = "outputs/default"
    trial_name: str = "exp"
    trial_dir: str = "outputs/default/exp"
    n_devices: int = 1

    resume: Optional[str] = None

    data_type: str = ""
    data: dict = field(default_factory=dict)

    system_type: str = ""
    system: dict = field(default_factory=dict)

    trainer: dict = field(default_factory=dict)
    checkpoint: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.tag and not self.use_timestamp:
            raise ValueError(
                "Either tag is specified or use_timestamp is True.")
        self.trial_name = self.tag
        if self.timestamp is None:
            self.timestamp = ""
            if self.use_timestamp:
                self.timestamp = datetime.now().strftime("@%Y%m%d-%H%M%S")
        self.trial_name += self.timestamp
        self.exp_dir = os.path.join(self.exp_root_dir, self.name)
        self.trial_dir = os.path.join(self.exp_dir, self.trial_name)


def load_config(*yamls: str, cli_args: Optional[List[str]] = None,
                makedirs: bool = True, **kwargs) -> ExperimentConfig:
    """YAML file(s) + CLI dotlist + kwargs -> resolved ExperimentConfig.
    `makedirs` creates the trial directory."""
    cfg: Dict = {}
    for path in yamls:
        with open(path) as f:
            cfg = merge(cfg, yaml.safe_load(f) or {})
    cfg = merge(cfg, from_dotlist(cli_args or []))
    cfg = resolve(merge(cfg, kwargs))
    unknown = set(cfg) - {f.name for f in dataclasses.fields(
        ExperimentConfig)}
    if unknown:
        raise ValueError(f"unknown top-level config keys: {sorted(unknown)}")
    scfg = ExperimentConfig(**cfg)
    if makedirs:
        os.makedirs(scfg.trial_dir, exist_ok=True)
    return scfg


def dump_config(path: str, config) -> None:
    """An ExperimentConfig (or a plain dict) as YAML."""
    data = (dataclasses.asdict(config) if dataclasses.is_dataclass(config)
            else config)
    with open(path, "w") as fp:
        yaml.safe_dump(data, fp, sort_keys=False)
