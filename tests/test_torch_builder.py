"""The port's builder refuses the stage-2 weight bootstraps it cannot load.

JAX lifts `shape_model.pretrained_model_name_or_path`, `system.weights`
and `system.weights_ignore_modules` into the system config when they are
truthy (open_diffusiongs_tpu/systems/builder.py:96-103) and loads them
(object_system.py:114-140).  Until the port loads weights, a truthy value
raises NotImplementedError naming the key; a missing, null or empty value
builds, as in JAX.
"""

import os

import pytest

from open_diffusiongs_tpu_torch.systems import builder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "diffusionGS_rel.yaml")
TINY = dict(width=64, num_layers=2, patch_size=8, dim_heads=32)
SET = {
    "shape_model.pretrained_model_name_or_path": "ckpt/stage1",
    "system.weights": "ckpt/stage1/model.ckpt",
    "system.weights_ignore_modules": ["image_token_decoder"],
}


def _system_cfg(key=None, value=None):
    cfg = builder.load_config(CONFIG)
    system_cfg = dict(cfg["system"], use_lpips=False)
    system_cfg["shape_model"] = dict(system_cfg["shape_model"], **TINY)
    if key is not None:
        block, name = key.split(".")
        target = (system_cfg if block == "system"
                  else system_cfg["shape_model"])
        target[name] = value
    return cfg["system_type"], system_cfg


def test_every_weight_key_is_covered():
    assert set(builder.WEIGHT_KEYS) == set(SET)


@pytest.mark.parametrize("key", sorted(SET))
def test_a_set_weight_key_raises_naming_it(key):
    system_type, system_cfg = _system_cfg(key, SET[key])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        builder.build_system(system_type, system_cfg)


@pytest.mark.parametrize("empty", [None, ""])
@pytest.mark.parametrize("key", sorted(SET))
def test_a_null_or_empty_weight_key_builds(key, empty):
    if key.endswith("ignore_modules") and empty == "":
        empty = []
    system_type, system_cfg = _system_cfg(key, empty)
    system = builder.build_system(system_type, system_cfg)
    assert system.model.transformer is not None


def test_the_flagship_config_leaves_the_weight_keys_unset():
    system_type, system_cfg = _system_cfg()
    builder.build_system(system_type, system_cfg)
