"""The port's builder lifts the stage-2 weight bootstraps and the system
loads them.

JAX lifts `shape_model.pretrained_model_name_or_path`, `system.weights`
and `system.weights_ignore_modules` into the system config when they are
truthy (open_diffusiongs_tpu/systems/builder.py:96-103) and
`load_pretrained` loads them after init (object_system.py:114-140): the
first strict, the second non-strict without the ignored modules.  A
missing, null or empty value builds and loads nothing.
"""

import os

import pytest
import torch

from open_diffusiongs_tpu_torch.systems import builder
from open_diffusiongs_tpu_torch.systems.object_system import \
    ObjectSystemConfig
from open_diffusiongs_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "diffusionGS_rel.yaml")
TINY = dict(width=64, num_layers=2, patch_size=8, dim_heads=32)
SET = {
    "shape_model.pretrained_model_name_or_path": "ckpt/stage1",
    "system.weights": "ckpt/stage1/model.ckpt",
    "system.weights_ignore_modules": ["image_token_decoder"],
}
FIELD = {key: key.split(".")[1] for key in SET}


def _system_cfg(settings=None):
    cfg = load_config(CONFIG, makedirs=False)
    system_cfg = dict(cfg.system, use_lpips=False)
    system_cfg["shape_model"] = dict(system_cfg["shape_model"], **TINY)
    for key, value in (settings or {}).items():
        block, name = key.split(".")
        target = (system_cfg if block == "system"
                  else system_cfg["shape_model"])
        target[name] = value
    return cfg.system_type, system_cfg


def _init(system_type, system_cfg, seed):
    system = builder.build_system(system_type, system_cfg)
    system.init_params(torch.Generator().manual_seed(seed))
    return system


def test_every_weight_key_is_covered():
    """Each key lands in its ObjectSystemConfig field, as in JAX."""
    system_type, system_cfg = _system_cfg(SET)
    cfg = builder.build_system(system_type, system_cfg).cfg
    for key, value in SET.items():
        want = tuple(value) if isinstance(value, list) else value
        assert getattr(cfg, FIELD[key]) == want, key
    assert set(FIELD.values()) <= set(ObjectSystemConfig.__dataclass_fields__)


@pytest.mark.parametrize("key", sorted(SET))
def test_a_set_weight_key_raises_naming_it(key, tmp_path):
    """A set key loads its source after init (the ignored module keeps its
    init values); the same key pointing at a missing source raises naming
    it."""
    system_type, system_cfg = _system_cfg()
    source = _init(system_type, system_cfg, seed=1).model.state_dict()
    ckpt = str(tmp_path / "stage1.ckpt")
    torch.save({"state_dict": {"shape_model." + k: v
                               for k, v in source.items()}}, ckpt)
    settings = {key: ckpt if isinstance(SET[key], str) else SET[key]}
    if key == "system.weights_ignore_modules":
        settings["system.weights"] = ckpt
    system = _init(*_system_cfg(settings), seed=0)
    init = {k: v.clone() for k, v in system.model.state_dict().items()}
    system.load_pretrained()
    for name, value in system.model.state_dict().items():
        kept = (key == "system.weights_ignore_modules"
                and name.startswith("image_token_decoder."))
        want = init[name] if kept else source[name]
        assert torch.equal(value, want), name
    assert not torch.equal(init["transformer.0.attn.qkv.weight"],
                           source["transformer.0.attn.qkv.weight"])

    missing = dict(settings, **{k: str(tmp_path / "absent.ckpt")
                                for k, v in settings.items()
                                if isinstance(v, str)})
    system = _init(*_system_cfg(missing), seed=0)
    with pytest.raises(FileNotFoundError, match=key.replace(".", r"\.")):
        system.load_pretrained()


@pytest.mark.parametrize("empty", [None, ""])
@pytest.mark.parametrize("key", sorted(SET))
def test_a_null_or_empty_weight_key_builds(key, empty):
    if key.endswith("ignore_modules") and empty == "":
        empty = []
    system_type, system_cfg = _system_cfg({key: empty})
    system = builder.build_system(system_type, system_cfg)
    assert system.model.transformer is not None
    assert not system.cfg.pretrained_model_name_or_path
    assert not system.cfg.weights and not system.cfg.weights_ignore_modules


def test_the_flagship_config_leaves_the_weight_keys_unset():
    system_type, system_cfg = _system_cfg()
    system = _init(system_type, system_cfg, seed=0)
    before = {k: v.clone() for k, v in system.model.state_dict().items()}
    system.load_pretrained()
    for name, value in system.model.state_dict().items():
        assert torch.equal(value, before[name]), name
