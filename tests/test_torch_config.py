"""The port's config loader (utils/config.py) against the JAX package's
(open_diffusiongs_tpu/utils/config.py): the same resolved
ExperimentConfig from every shipped YAML, with and without dotlist
overrides, the same refusals and the same C_max."""

import dataclasses
import glob
import os

import pytest

from open_diffusiongs_tpu.utils import config as jcfg
from open_diffusiongs_tpu_torch.utils import config as cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
PINNED = dict(use_timestamp=False, timestamp="@pinned")
# trained-statistics overrides as a serving call passes them (bench.py:
# 43-51), a PyYAML float and a PyYAML string, and a new key
OVERRIDES = ["system.shape_model.gs_raw_offset_scaling=-4.2",
             "system.shape_model.gs_raw_offset_opacity=3.0",
             "system.optimizer.args.lr=1e-6",
             "system.scheduler.args.eta_min=1.e-7",
             "system.raster.max_per_tile=2048", "seed=7"]


@pytest.mark.parametrize("overrides", [[], OVERRIDES],
                         ids=["yaml", "dotlist"])
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path, overrides):
    ours = cfg.load_config(path, cli_args=overrides, makedirs=False,
                           **PINNED)
    ref = jcfg.load_config(path, cli_args=overrides, makedirs=False,
                           **PINNED)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert "${" not in ours.tag and " " not in ours.tag   # rmspace
    if overrides:
        sm = ours.system["shape_model"]
        assert sm["gs_raw_offset_opacity"] == 3.0 and ours.seed == 7
        assert ours.system["optimizer"]["args"]["lr"] == "1e-6"


def test_unknown_top_level_key_is_refused(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("name: x\ntag: t\nsystem_typo: 1\n")
    with pytest.raises(ValueError) as ours:
        cfg.load_config(str(path), makedirs=False)
    with pytest.raises(ValueError) as ref:
        jcfg.load_config(str(path), makedirs=False)
    assert str(ours.value) == str(ref.value)
    assert "system_typo" in str(ours.value)


def test_trial_dir_is_made_only_when_asked(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(f"exp_root_dir: {tmp_path / 'out'}\nname: n\ntag: t\n"
                    "use_timestamp: false\n")
    c = cfg.load_config(str(path), makedirs=False)
    assert not os.path.exists(c.trial_dir)
    c = cfg.load_config(str(path))
    assert os.path.isdir(c.trial_dir) and c.trial_dir.endswith("n/t")


def test_dump_config_round_trips(tmp_path):
    c = cfg.load_config(CONFIGS[0], makedirs=False, **PINNED)
    cfg.dump_config(str(tmp_path / "ours.yaml"), c)
    jcfg.dump_config(str(tmp_path / "ref.yaml"), c)
    assert ((tmp_path / "ours.yaml").read_text()
            == (tmp_path / "ref.yaml").read_text())
    back = cfg.load_config(str(tmp_path / "ours.yaml"), makedirs=False)
    assert dataclasses.asdict(back) == dataclasses.asdict(c)


@pytest.mark.parametrize("expr,want", [
    ("${add:2,3}", 5), ("${sub:2,3}", -1), ("${mul:2,3}", 6),
    ("${div:3,2}", 1.5), ("${idiv:7,2}", 3), ("${basename:/a/b.ckpt}",
                                               "b.ckpt"),
    ("${rmspace:a b c,_}", "a_b_c"), ("${tuple2:0.5}", [0.5, 0.5]),
    ("${gt0:0}", False), ("${not:${gt0:1}}", False),
    ("${cmaxgt0:${system.w}}", True), ("${calc_exp_lr_decay_rate:4,2}",
                                          2.0),
    ("${cmaxgt0orcmaxgt0:0.0,${system.w}}", True),
    ("x${system.name}y", "xdity")])
def test_resolvers_match_jax(expr, want):
    tree = {"system": {"w": 0.5, "name": "dit"},
            "v": expr}
    assert cfg.resolve(tree)["v"] == jcfg.resolve(tree)["v"] == want


def test_c_max_matches_jax_on_the_loss_lambdas():
    specs = []
    for path in CONFIGS:
        loss = cfg.load_config(path, makedirs=False,
                               **PINNED).system.get("loss", {})
        specs += [v for k, v in loss.items() if k.startswith("lambda_")]
    specs += [[0, 1.0, 2.0, 10, 5.0, 20], [0.5, 1.5, 10]]
    assert len(specs) > 10
    for spec in specs:
        assert cfg.C_max(spec) == jcfg.C_max(spec), spec


def test_dotlist_needs_key_equals_value():
    with pytest.raises(ValueError, match="key=value"):
        cfg.from_dotlist(["system.weights"])
    assert cfg.from_dotlist(["a.b=", "a.c=[1, 2]"]) == \
        jcfg.from_dotlist(["a.b=", "a.c=[1, 2]"]) == {"a": {"b": None,
                                                           "c": [1, 2]}}
