"""The port's synthetic-tree generators
(open_diffusiongs_tpu_torch/tools/make_synthetic_{objaverse,re10k}.py)
against the root JAX tools (tools/make_synthetic_*.py, imported by path)
at tiny sizes, on the CPU:

- the numpy scene draws (objects, rooms, trajectories) equal bit for bit
  for the same seed, and the generator's state after them too;
- `render_object` / `render_scene` within the rasterizer bar (atol 2e-5,
  tests/test_rasterize.py), depth where both alphas > 0.3 (the cut at 0.25
  moves depth a lot for a small alpha difference), the PNG bytes within
  1 LSB, and the overflow counters and binned entries equal to those of
  the JAX renders (recorded by wrapping JAX's `render`);
- where the object's capacities clip (K = 512 at 64² with 4,096
  Gaussians, D = 16 at 192² with 128), the counters nonzero and equal to
  JAX's, and each pixel beyond the bar a flip of the blend's skip or stop
  threshold;
- both `main`s write trees that load through the port's ObjaverseDataset
  (the same sample as JAX's dataset, every camera at norm_radius, the
  depths' points inside the object) and RE10KDataset (the shapes and pose
  normalisation of tests/test_synth_re10k.py);
- without `--device cpu`, on a machine with no card, both raise.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.data import objaverse as jobj
from open_diffusiongs_tpu.ops import rasterize as jrast
from open_diffusiongs_tpu_torch.data.objaverse import ObjaverseDataset
from open_diffusiongs_tpu_torch.data.re10k import RE10KConfig, RE10KDataset
from open_diffusiongs_tpu_torch.ops import blend_kernel
from open_diffusiongs_tpu_torch.ops.rays import pixel_rays
from open_diffusiongs_tpu_torch.tools import make_synthetic_objaverse as po
from open_diffusiongs_tpu_torch.tools import make_synthetic_re10k as pr

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 2e-5              # the rasterizer's forward parity bar
DEPTH_ALPHA = 0.3
COUNTERS = ("overflow_tiles", "overflow_gaussians", "binned_entries")


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jo = _root_tool("make_synthetic_objaverse")
jr = _root_tool("make_synthetic_re10k")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU renders: beside the other
    test workers on a few cores, more threads only spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(rgb, alpha=None):
    img = rgb if alpha is None else np.concatenate([rgb, alpha[..., None]],
                                                   axis=-1)
    return (img * 255).astype(np.uint8).astype(np.int16)


def _assert_fields_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "Gaussians"
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture
def jax_counters(monkeypatch):
    """The counters of every JAX render call, summed."""
    seen = dict.fromkeys(COUNTERS, 0)
    render = jrast.render

    def recording(*args, **kwargs):
        out = render(*args, **kwargs)
        for k in COUNTERS:
            seen[k] += int(out[k])
        return out

    monkeypatch.setattr(jrast, "render", recording)
    return seen


@pytest.mark.parametrize("seed", [0, 3])
def test_object_draws_bit_equal(seed):
    assert po.view_layout() == jo.view_layout()
    assert (po.DIS, po.FXFY) == (jo.DIS, jo.FXFY)
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for n in (300, 17):
        _assert_fields_equal(po.make_scene(rng_p, n), jo.make_scene(rng_j, n))
    assert rng_p.random() == rng_j.random()


@pytest.mark.parametrize("seed,step,lobes,frames", [(0, 0.5, 4, 5),
                                                    (2, 0.18, 10, 48)])
def test_room_draws_bit_equal(seed, step, lobes, frames):
    assert (pr.ROOM_X, pr.ROOM_Y, pr.ROOM_Z, pr.FOCAL_REL) == (
        jr.ROOM_X, jr.ROOM_Y, jr.ROOM_Z, jr.FOCAL_REL)
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    _assert_fields_equal(pr.make_room(rng_p, step=step, n_lobes=lobes),
                         jr.make_room(rng_j, step=step, n_lobes=lobes))
    np.testing.assert_array_equal(pr.trajectory(rng_p, frames),
                                  jr.trajectory(rng_j, frames))
    assert rng_p.random() == rng_j.random()


def _object_apart(got, want):
    """[V, h, w] bool: alpha or rgb x alpha beyond ATOL, or rgb or depth
    where both alphas > DEPTH_ALPHA."""
    (rgb, alpha, depth), (rgb_w, alpha_w, depth_w) = got[:3], want[:3]
    both = (alpha > DEPTH_ALPHA) & (alpha_w > DEPTH_ALPHA)
    return ((np.abs(alpha - alpha_w) > ATOL)
            | (np.abs(rgb * alpha[..., None] - rgb_w * alpha_w[..., None])
               > ATOL).any(-1)
            | both & ((np.abs(rgb - rgb_w) > ATOL).any(-1)
                      | (np.abs(depth - depth_w) > ATOL)))


@pytest.mark.parametrize("res,n,clipped", [
    (64, 4096, "overflow_gaussians"), (192, 128, "overflow_tiles")])
def test_render_object_matches_jax_where_capacities_clip(
        jax_counters, monkeypatch, res, n, clipped):
    """Where D = 16 or K = 512 clips, the counters equal JAX's and are
    nonzero; a few pixels hold a Gaussian whose alpha sits on the blend's
    1/255 skip (or a transmittance on its 1e-4 stop), which f32 rounding
    flips: every pixel beyond the bar agrees with JAX once the port's
    threshold moves by 0.1 % (chip_smoke.py's SYNTH_FLIP_MOVES), at most
    1e-3 of them are apart, and the rest hold the bar."""
    gauss = jo.make_scene(np.random.default_rng(0), n)
    want = jo.render_object(gauss, res)
    got = po.render_object(gauss, res, "cpu")
    counters = got[4]
    assert counters == jax_counters
    assert counters[clipped] > 0
    apart = _object_apart(got, want)
    assert apart.mean() <= 1e-3
    left = apart.copy()
    for name, scale in (("ALPHA_MIN", 1.001), ("ALPHA_MIN", 0.999),
                        ("EARLY_STOP_T", 1.001), ("EARLY_STOP_T", 0.999)):
        views = np.flatnonzero(left.any(axis=(1, 2)))
        if len(views):          # re-render only the views still apart
            with monkeypatch.context() as m:
                m.setattr(blend_kernel, name,
                          getattr(blend_kernel, name) * scale)
                left[views] &= _object_apart(
                    po.render_object(gauss, res, "cpu", views=views),
                    [x[views] for x in want[:3]])
    assert not left.any(), np.argwhere(left)[:5]
    png = np.abs(_png(*got[:2]) - _png(*want[:2])).max(-1)
    assert png[~apart].max() <= 1


def test_render_object_matches_jax(jax_counters):
    res = 64
    gauss = jo.make_scene(np.random.default_rng(0), 256)
    rgb_j, alpha_j, depth_j, c2w_j = jo.render_object(gauss, res)
    rgb, alpha, depth, c2w, counters = po.render_object(
        po.make_scene(np.random.default_rng(0), 256), res, "cpu")
    np.testing.assert_array_equal(c2w, c2w_j)
    assert counters == jax_counters
    assert counters["binned_entries"] > 0
    assert counters["overflow_tiles"] == counters["overflow_gaussians"] == 0
    np.testing.assert_allclose(alpha, alpha_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(rgb * alpha[..., None],
                               rgb_j * alpha_j[..., None], rtol=0, atol=ATOL)
    both = (alpha > DEPTH_ALPHA) & (alpha_j > DEPTH_ALPHA)
    assert both.mean() > 0.1
    np.testing.assert_allclose(rgb[both], rgb_j[both], rtol=0, atol=ATOL)
    np.testing.assert_allclose(depth[both], depth_j[both], rtol=0, atol=ATOL)
    assert np.abs(_png(rgb, alpha) - _png(rgb_j, alpha_j)).max() <= 1


def test_render_scene_matches_jax(jax_counters):
    res = 32
    rng = np.random.default_rng(0)
    room = jr.make_room(rng, step=0.5, n_lobes=4)
    c2ws = jr.trajectory(rng, 5)
    rgb_j, overflow_j = jr.render_scene(room, c2ws, res)
    rgb, counters = pr.render_scene(room, c2ws, res, "cpu")
    assert counters == jax_counters
    assert overflow_j == counters["overflow_tiles"] \
        + counters["overflow_gaussians"] == 0
    np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=ATOL)
    assert np.abs(_png(rgb) - _png(rgb_j)).max() <= 1
    assert float(rgb.std()) > 0.05


def test_object_tree_loads(tmp_path):
    out = tmp_path / "obja"
    summary = po.main(["--out", str(out), "--objects", "2", "--res", "32",
                       "--gaussians", "256", "--device", "cpu"])
    assert [o["overflow_tiles"] for o in summary["per_object"]] == [0, 0]
    uids = json.loads((out / "meta" / "train.json").read_text())
    assert uids == ["synth/000", "synth/001"]
    assert json.loads((out / "meta" / "test.json").read_text()) == uids
    view = out / "images" / "synth/001" / "campos_512_v4" / "00039"
    assert {p.name for p in view.iterdir()} == {
        "00039.png", "00039.json", "00039_nd.exr"}
    cfg = dict(local_dir=str(out / "meta"), image_dir=str(out / "images") + "/",
               gen_idxs=[30, 33, 36, 39], sel_views=6, gen_views=4,
               training_res=[32, 32], norm_radius=3.0, gen_rel_idxs=True)
    port = ObjaverseDataset(cfg, split="train", seed=0)
    ref = jobj.ObjaverseDataset(cfg, split="train", seed=0)
    for i in (0, 1):
        s, r = port[i], ref[i]
        for k, v in r.items():
            np.testing.assert_array_equal(s[k], v, err_msg=k)
        assert s["rgbs"].shape == (10, 3, 32, 32)
        assert s["rgbs_input"].shape == (4, 3, 32, 32)
        np.testing.assert_allclose(
            np.linalg.norm(s["c2ws"][:, :3, 3], axis=-1), 3.0, atol=1e-5)
        # the supervised pixels' depths land on the object: inside its box
        # (|xyz| <= 0.85 plus a few sigmas) at the loader's scale.  The
        # loader zeroes depths nearer than the camera distance - 0.867
        # (data/base.py:20-31), which cuts the blob's nearest corners
        ray_o, ray_d = pixel_rays(torch.from_numpy(s["c2ws"]),
                                  torch.from_numpy(s["fxfycxcys"]), 32, 32)
        depth = s["depths"][:, 0]
        mask = s["masks"][:, 0] > 0.5
        assert mask.mean() > 0.1 and (depth[mask] > 0).mean() > 0.9
        xyz = (ray_o + ray_d * torch.from_numpy(depth)[..., None]).numpy()
        assert np.abs(xyz[mask & (depth > 0)]).max() < 1.2 * 3.0 / po.DIS


def test_re10k_tree_loads(tmp_path):
    out = tmp_path / "re10k"
    summary = pr.main(["--out", str(out), "--scenes", "1", "--frames", "5",
                       "--res", "64", "--wall-step", "0.5", "--lobes", "4",
                       "--device", "cpu"])
    assert summary["per_scene"][0]["n_gauss"] == 1549
    full_list = out / "full_list.txt"
    meta = json.loads(
        open(full_list.read_text().splitlines()[0].strip()).read())
    assert meta["scene_name"] == "synthscene000"
    assert len(meta["frames"]) == 5
    w2c = np.asarray(meta["frames"][0]["w2c"])
    np.testing.assert_allclose(w2c[:3, :3] @ w2c[:3, :3].T, np.eye(3),
                               atol=1e-8)
    cfg = RE10KConfig(local_dir=str(full_list), training_res=[64, 64],
                      sel_views=3, sel_views_train=1, batch_size=1)
    s = RE10KDataset(cfg, split="train", seed=0)[0]
    assert s["rgbs"].shape == (4, 3, 64, 64)
    assert s["rgbs_input"].shape == (4, 3, 64, 64)
    assert float(s["rgbs"].std()) > 0.05
    assert abs(float(np.abs(s["c2ws"][:, :3, 3]).max()) - 1 / 1.35) < 1e-3


@pytest.mark.parametrize("tool", [po, pr], ids=["objaverse", "re10k"])
def test_default_device_raises_without_a_card(tmp_path, monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--out", str(tmp_path / "tree")])
    assert not os.path.exists(tmp_path / "tree")
