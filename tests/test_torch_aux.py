"""The port's auxiliary modules against the JAX package's, on the CPU:
diffusion/diffusion_utils.py, diffusion/ddim.py and diffusion/rf.py (f32,
rtol 1e-6, plus the JAX tests' own contracts, tests/test_parity_tools.py:
22-56 and tests/test_misc_utils.py:20-40), ops/knn.py (rtol 1e-3 / atol
1e-5, tests/test_parity_tools.py:12-19; duplicate points, blocks that do
not divide N), utils/fisheye.py (atol 1e-5 for both parameter layouts,
tests/test_camera_rays.py:82-110), utils/visualizers.py and the savers of
utils/saving.py (equal arrays or bytes; the contracts of
tests/test_misc_utils.py:93-160, 203-222) and `save_gaussians`' turntable
(frames within 2e-5 of JAX's render, the rasterizer's forward bar).
Inputs are numpy draws handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm as scipy_norm

from open_diffusiongs_tpu.diffusion import ddim as jddim
from open_diffusiongs_tpu.diffusion import diffusion_utils as jdu
from open_diffusiongs_tpu.diffusion import rf as jrf
from open_diffusiongs_tpu.ops import knn as jknn
from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.ops.gaussians import NumpyGaussians as JNumpyG
from open_diffusiongs_tpu.utils import fisheye as jfish
from open_diffusiongs_tpu.utils import saving as jsaving
from open_diffusiongs_tpu.utils import visualizers as jvis
from open_diffusiongs_tpu_torch.diffusion import ddim, diffusion_utils, rf
from open_diffusiongs_tpu_torch.ops import knn
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.ops.gaussians import NumpyGaussians
from open_diffusiongs_tpu_torch.utils import fisheye, saving, visualizers
from utils3d import random_gaussians

F32 = dict(rtol=1e-6, atol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# diffusion_utils
# ---------------------------------------------------------------------------


def test_diffusion_utils_match_jax(rng):
    m1, lv1, m2, lv2 = rng.normal(size=(4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        diffusion_utils.normal_kl(_t(m1), _t(lv1), _t(m2), _t(lv2)).numpy(),
        np.asarray(jdu.normal_kl(_j(m1), _j(lv1), _j(m2), _j(lv2))),
        rtol=1e-6, atol=1e-7)
    # 0.5 (1 + tanh): where tanh nears -1 the sum cancels, and one ulp of
    # tanh (XLA's and torch's differ by it) is 6e-8 absolute
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        diffusion_utils.approx_standard_normal_cdf(_t(x)).numpy(),
        np.asarray(jdu.approx_standard_normal_cdf(_j(x))), rtol=1e-6,
        atol=1.2e-7)
    # the three branches: x < -0.999, x > 0.999 and between
    x = np.concatenate([np.float32([-1.0, -0.9995, 0.9995, 1.0]),
                        rng.uniform(-1, 1, 60).astype(np.float32)])
    # means near x: far from them both CDFs round to 0 or 1 and the
    # clipped log of their difference is f32 noise in either package
    means = (x + rng.normal(0, 0.02, x.shape)).astype(np.float32)
    log_scales = rng.uniform(-4, -2, x.shape).astype(np.float32)
    np.testing.assert_allclose(
        diffusion_utils.discretized_gaussian_log_likelihood(
            _t(x), means=_t(means), log_scales=_t(log_scales)).numpy(),
        np.asarray(jdu.discretized_gaussian_log_likelihood(
            _j(x), means=_j(means), log_scales=_j(log_scales))),
        rtol=1e-6, atol=1e-6)


def test_diffusion_utils_contracts():
    """tests/test_misc_utils.py:20-40 on the port."""
    m, lv = torch.tensor([0.3, -1.0]), torch.tensor([0.1, -0.5])
    np.testing.assert_allclose(
        diffusion_utils.normal_kl(m, lv, m, lv).numpy(), 0.0, atol=1e-7)
    got = float(diffusion_utils.normal_kl(torch.tensor(0.5),
                                          torch.tensor(0.2),
                                          torch.tensor(0.0),
                                          torch.tensor(0.0)))
    np.testing.assert_allclose(got, 0.5 * (-1 - 0.2 + np.exp(0.2) + 0.25),
                               rtol=1e-6)
    x = torch.linspace(-3, 3, 13)
    np.testing.assert_allclose(
        diffusion_utils.approx_standard_normal_cdf(x).numpy(),
        scipy_norm.cdf(x.numpy()), atol=5e-3)
    ll = [float(diffusion_utils.discretized_gaussian_log_likelihood(
        torch.tensor([0.0]), means=torch.tensor([mu]),
        log_scales=torch.tensor([-3.0]))[0]) for mu in (0.0, 0.5)]
    assert ll[0] > ll[1]


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prediction_type",
                         ["sample", "epsilon", "v_prediction"])
@pytest.mark.parametrize("clip_sample", [True, False])
def test_ddim_matches_jax(rng, prediction_type, clip_sample):
    kw = dict(num_train_timesteps=100, prediction_type=prediction_type,
              clip_sample=clip_sample)
    mine, ref = ddim.DDIMScheduler(**kw), jddim.DDIMScheduler(**kw)
    mine.set_timesteps(10)
    ref.set_timesteps(10)
    np.testing.assert_array_equal(mine.timesteps, ref.timesteps)
    np.testing.assert_array_equal(mine.alphas_cumprod, ref.alphas_cumprod)
    for name in ("alphas_cumprod", "final_alpha_cumprod", "timesteps"):
        assert not isinstance(getattr(mine, name), torch.Tensor), name
    x0, noise, out = rng.normal(size=(3, 2, 3, 4, 4)).astype(np.float32)
    t = np.array([50, 90])
    np.testing.assert_allclose(
        mine.add_noise(_t(x0), _t(noise), torch.from_numpy(t)).numpy(),
        np.asarray(ref.add_noise(_j(x0), _j(noise), jnp.asarray(t))), **F32)
    for t_i in (90, 50, 0):       # t = 0 steps to final_alpha_cumprod
        got = mine.step(_t(out), t_i, _t(x0))
        want = ref.step(_j(out), t_i, _j(x0))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_ddim_eta_noise_matches_jax(rng, monkeypatch):
    """eta > 0 adds sigma * z: with the port's z (from its generator) fed to
    JAX's step through its normal draw, the updates agree."""
    mine, ref = ddim.DDIMScheduler(100), jddim.DDIMScheduler(100)
    mine.set_timesteps(10)
    ref.set_timesteps(10)
    x, out = rng.normal(size=(2, 2, 5)).astype(np.float32)
    z = torch.randn((2, 5), generator=torch.Generator().manual_seed(0))
    got = mine.step(_t(out), 50, _t(x), eta=0.7,
                    generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(z.numpy()))
    want = ref.step(_j(out), 50, _j(x), eta=0.7, rng=jax.random.PRNGKey(3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="generator"):
        mine.step(_t(out), 50, _t(x), eta=0.7)


def test_ddim_roundtrip(rng):
    """tests/test_parity_tools.py:22-40 on the port: a perfect x0
    predictor brings DDIM to clip(x0)."""
    s = ddim.DDIMScheduler(num_train_timesteps=100, prediction_type="sample")
    s.set_timesteps(10)
    assert len(s.timesteps) == 10
    x0 = _t(rng.normal(size=(2, 3)))
    x = _t(rng.normal(size=(2, 3)))
    for t_i in s.timesteps:
        x, _ = s.step(x0.clamp(-1, 1), int(t_i), x)
    np.testing.assert_allclose(x.numpy(), x0.clamp(-1, 1).numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# Rectified flow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_rf_matches_jax(rng, shift):
    mine = rf.FlowMatchEulerDiscreteScheduler(1000, shift=shift)
    ref = jrf.FlowMatchEulerDiscreteScheduler(1000, shift=shift)
    np.testing.assert_array_equal(mine.sigmas, ref.sigmas)
    mine.set_timesteps(8)
    ref.set_timesteps(8)
    for name in ("sigmas", "timesteps"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
        assert isinstance(getattr(mine, name), np.ndarray), name
    x0, eps, v = rng.normal(size=(3, 2, 3, 4, 4)).astype(np.float32)
    idx = np.array([0, 5])
    np.testing.assert_allclose(
        mine.scale_noise(_t(x0), torch.from_numpy(idx), _t(eps)).numpy(),
        np.asarray(ref.scale_noise(_j(x0), jnp.asarray(idx), _j(eps))),
        **F32)
    for i in (0, 4, 7):
        np.testing.assert_allclose(
            mine.step(_t(v), i, _t(x0)).numpy(),
            np.asarray(ref.step(_j(v), i, _j(x0))), **F32)
    t = rng.uniform(0.01, 0.99, 50).astype(np.float32)
    np.testing.assert_allclose(
        rf.logit_normal_timestep_density(_t(t), 0.3, 0.8).numpy(),
        np.asarray(jrf.logit_normal_timestep_density(_j(t), 0.3, 0.8)),
        rtol=2e-6)


def test_rf_sample_logit_normal_matches_jax(monkeypatch):
    """sigmoid(m + s z) on the same z: the port's z (from its generator)
    fed to JAX's function through its normal draw."""
    shape, m, s = (300,), 0.2, 1.3
    z = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    got = rf.sample_logit_normal(torch.Generator().manual_seed(5), shape,
                                 m=m, s=s)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shp: jnp.asarray(z.numpy()))
    want = jrf.sample_logit_normal(jax.random.PRNGKey(0), shape, m=m, s=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_rf_contracts(rng):
    """tests/test_parity_tools.py:43-56 on the port: Euler steps with the
    exact velocity recover x0; the draws lie in (0, 1) around 0.5."""
    s = rf.FlowMatchEulerDiscreteScheduler(num_train_timesteps=1000)
    s.set_timesteps(8)
    assert len(s.sigmas) == 9
    x0, eps = _t(rng.normal(size=(2, 4))), _t(rng.normal(size=(2, 4)))
    x = eps
    for i in range(8):
        x = s.step(eps - x0, i, x)
    np.testing.assert_allclose(x.numpy(), x0.numpy(), atol=1e-5)
    t = rf.sample_logit_normal(torch.Generator().manual_seed(0), (1000,))
    assert (t > 0).all() and (t < 1).all() and 0.3 < float(t.mean()) < 0.7


# ---------------------------------------------------------------------------
# knn
# ---------------------------------------------------------------------------


def _knn_brute(pts, k=3):
    p = pts.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :k].mean(1)


@pytest.mark.parametrize("block", [None, 128, 97])
def test_knn_matches_jax(rng, block):
    """JAX's blocked top-k (block 128 there) and the brute force; the
    port's blocks of 128 / 97 rows do not divide N = 500."""
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    pts[7] = pts[3]                       # a duplicate: distance exactly 0
    pts[11] = pts[3]
    got = knn.knn_mean_sq_dist(torch.from_numpy(pts), k=3, block=block)
    want = np.asarray(jknn.knn_mean_sq_dist(jnp.asarray(pts), k=3,
                                            block=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _knn_brute(pts), rtol=1e-3,
                               atol=1e-5)
    assert got.dtype == torch.float32 and (got >= 0).all()
    # points 3, 7, 11 coincide: two of the three neighbours are at 0
    three = _knn_brute(pts)[[3, 7, 11]]
    np.testing.assert_allclose(got.numpy()[[3, 7, 11]], three, rtol=1e-3,
                               atol=1e-6)


def test_knn_block_rows_and_small_sets():
    rows = knn.knn_block_rows(262146)             # the 256^2 asset
    assert 256 <= rows and rows * 262146 * 8 <= knn.BLOCK_BYTES
    assert knn.knn_block_rows(10) == 10
    pts = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [0.0, 2, 0]])
    got = knn.knn_mean_sq_dist(pts, k=3)
    assert torch.isinf(got).all()                # 2 other points < k = 3
    np.testing.assert_allclose(knn.knn_mean_sq_dist(pts, k=2).numpy(),
                               [2.5, 3.0, 4.5])


# ---------------------------------------------------------------------------
# fisheye
# ---------------------------------------------------------------------------


def _fisheye_case():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(2, 64, 3))
    xyz[..., 2] = np.abs(xyz[..., 2]) + 0.5
    params = np.zeros((2, 16))
    params[:, 0:2] = [350.0, 352.0]
    params[:, 2:4] = [320.0, 240.0]
    params[:, 4:10] = [[0.05, -0.01, 0.002, 0.0, 0.0, 0.0]] * 2
    params[:, 10:12] = [[1e-3, -5e-4]] * 2
    params[:, 12:16] = [[2e-4, -1e-4, 5e-5, 1e-4]] * 2
    return xyz.astype(np.float32), params.astype(np.float32)


@pytest.mark.parametrize("layout", [16, 15])
def test_fisheye_matches_jax(layout):
    xyz, params = _fisheye_case()
    if layout == 15:                       # fu == fv
        params = np.concatenate([params[:, :1], params[:, 2:]], axis=1)
    uv = fisheye.fisheye624_project(_t(xyz), _t(params))
    juv = jfish.fisheye624_project(_j(xyz), _j(params))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-6,
                               atol=1e-4)     # pixels of a ~350 px focal
    rays = fisheye.fisheye624_unproject(uv, _t(params))
    jrays = jfish.fisheye624_unproject(juv, _j(params))
    np.testing.assert_allclose(rays.numpy(), np.asarray(jrays), atol=1e-5)
    # the round trip (tests/test_camera_rays.py:82-110)
    np.testing.assert_allclose(rays.numpy(), xyz / xyz[..., 2:3], atol=1e-5)


def test_fisheye_refuses_bad_shapes():
    with pytest.raises(ValueError, match="15|16"):
        fisheye.fisheye624_project(torch.zeros(1, 4, 3), torch.zeros(1, 14))


# ---------------------------------------------------------------------------
# visualizers and savers
# ---------------------------------------------------------------------------


def test_visualizers_match_jax(rng, tmp_path):
    v = rng.uniform(size=(8, 8)).astype(np.float32)
    for cmap in ("viridis", "turbo"):
        np.testing.assert_array_equal(visualizers.colormap(v, cmap=cmap),
                                      jvis.colormap(v, cmap=cmap))
        np.testing.assert_array_equal(
            visualizers.colormap(v, 0.2, 0.7, cmap=cmap),
            jvis.colormap(v, 0.2, 0.7, cmap=cmap))
    d = visualizers.depth_to_rgb(v)
    assert d.dtype == np.uint8
    np.testing.assert_array_equal(d, jvis.depth_to_rgb(v))
    img = (rng.uniform(size=(8, 8, 3)) * 255).astype(np.uint8)
    tag = visualizers.to_image_embed_tag(img)
    assert tag.startswith('<img src="data:image/png;base64,')
    assert tag == jvis.to_image_embed_tag(img)
    table = visualizers.to_single_row_table("cap", tag)
    assert table == jvis.to_single_row_table("cap", tag)
    pages = [m.save_html(str(tmp_path / f"{i}.html"), table)
             for i, m in enumerate((visualizers, jvis))]
    assert open(pages[0]).read() == open(pages[1]).read()
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    faces = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    cols = rng.uniform(size=(4, 3))
    for name, f, c in (("mesh", faces, None), ("pts", None, cols),
                       ("cmesh", faces, cols)):
        a = visualizers.save_viewer_html(str(tmp_path / f"{name}0.html"),
                                         verts, f, c)
        b = jvis.save_viewer_html(str(tmp_path / f"{name}1.html"), verts,
                                  f, c)
        html = open(a).read()
        assert html == open(b).read()
        assert "webgl" in html and "<canvas" in html
        assert ("TRIANGLES" in html) and (
            ('"mesh"' in html) == (f is not None))


def _same_files(a, b):
    assert os.path.basename(a) == os.path.basename(b)
    assert open(a, "rb").read() == open(b, "rb").read(), a


def test_save_obj_matches_jax(tmp_path):
    """Textured OBJ / MTL and the plain OBJ (tests/test_misc_utils.py:
    103-135), byte for byte against JAX's writer."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    nrm = np.array([[0, 0, 1]] * 3, np.float32)
    rgb = np.array([[1, 0, 0]] * 3, np.float32)
    tex = np.full((8, 8, 3), 0.5, np.float32)
    kw = dict(v_nrm=nrm, v_tex=uv, v_rgb=rgb, save_mat=True, map_Kd=tex,
              map_Bump=tex * 0.5)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = saving.save_obj(str(tmp_path / "a" / "mesh"), v, f, **kw)
    want = jsaving.save_obj(str(tmp_path / "b" / "mesh"), v, f, **kw)
    assert {os.path.basename(p) for p in got} == {
        "mesh.obj", "mesh.mtl", "texture_kd.png", "texture_nrm.png"}
    for a, b in zip(got, want):
        _same_files(a, b)
    obj = open(tmp_path / "a" / "mesh.obj").read()
    assert "mtllib mesh.mtl" in obj and "f 1/1/1 2/2/2 3/3/3" in obj
    (plain,) = saving.save_obj(str(tmp_path / "a" / "m.obj"), v, f)
    (jplain,) = jsaving.save_obj(str(tmp_path / "b" / "m.obj"), v, f)
    _same_files(plain, jplain)
    assert "f 1// 2// 3//" in open(plain).read()


def test_breadth_savers_match_jax(tmp_path):
    """save_grayscale_image, save_data, save_img_sequence and
    save_xyz_points (tests/test_misc_utils.py:138-160) byte for byte."""
    depth = np.linspace(0, 1, 64).reshape(8, 8)
    pts = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    out = {}
    for tag, m in (("a", saving), ("b", jsaving)):
        d = tmp_path / tag
        seq = d / "frames"
        seq.mkdir(parents=True)
        for i in range(3):
            m.save_image(str(seq / f"{i:03d}.png"),
                         np.full((16, 16, 3), i / 3.0, np.float32))
        out[tag] = [
            m.save_grayscale_image(str(d / "d.png"), depth,
                                   data_range=(0, 1), cmap="turbo"),
            m.save_grayscale_image(str(d / "v.png"), depth, cmap="viridis"),
            m.save_grayscale_image(str(d / "g.png"), depth, cmap=None),
            m.save_img_sequence(str(d / "seq.avi"), str(seq)),
            m.save_xyz_points(str(d / "pts.ply"), pts, normals=pts),
            m.save_xyz_points(str(d / "p.ply"), pts)]
        npz = m.save_data(str(d / "pkg"), {"a": np.ones(3), "b": depth})
        one = m.save_data(str(d / "one"), depth)
        out[tag + "npz"] = (dict(np.load(npz)), dict(np.load(one)))
    for a, b in zip(out["a"], out["b"]):
        _same_files(a, b)
    for a, b in zip(out["anpz"], out["bnpz"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert "element vertex 10" in open(out["a"][4]).read()


def test_save_gaussians_turntable_matches_jax(tmp_path, monkeypatch):
    """The PLY byte for byte and the turntable's frames (caught on their
    way to the AVI writer) within 2e-5 of JAX's render; channels last."""
    rng = np.random.default_rng(4)
    g = random_gaussians(rng, 1, 120, scale_mean=-3.0)
    frames = {}

    def catch(tag):
        def save_video(path, fr, fps=30):
            frames[tag] = (os.path.basename(path), np.asarray(fr), fps)
            return path
        return save_video

    monkeypatch.setattr(saving, "save_video", catch("port"))
    monkeypatch.setattr(jsaving, "save_video", catch("jax"))
    kw = dict(save_turntable=True, h=32, w=32, turntable_frames=4, fps=12)
    p = saving.save_gaussians(NumpyGaussians(*(x[0] for x in g)),
                              str(tmp_path / "a" / "g.ply"),
                              raster_cfg=rz.RasterizeConfig(32, 256, 32),
                              device="cpu", **kw)
    q = jsaving.save_gaussians(JNumpyG(*(x[0] for x in g)),
                               str(tmp_path / "b" / "g.ply"),
                               raster_cfg=jrz.RasterizeConfig(32, 256, 32),
                               **kw)
    _same_files(p, q)
    name, got, fps = frames["port"]
    assert (name, fps) == ("g_turntable.avi", 12)
    assert got.shape == (4, 32, 32, 3) and got.dtype == np.float32
    assert frames["jax"][0] == name
    np.testing.assert_allclose(got, frames["jax"][1], atol=2e-5, rtol=0)
    # without the turntable only the PLY is written
    frames.clear()
    saving.save_gaussians(NumpyGaussians(*(x[0] for x in g)),
                          str(tmp_path / "c.ply"), device="cpu")
    assert not frames and os.path.exists(tmp_path / "c.ply")
