"""PyTorch port vs the JAX package: the rasterizer forward.

On CPU tensors the port's `render` blends through `blend_tiles_ref`, the
plain twin of the CUDA blend kernel (chip_smoke.py phase 4 holds the kernel
against it on the GPU).  Bars: atol 2e-5, the rasterizer forward bar of
tests/test_rasterize.py and tests/test_golden.py — the port multiplies the
transmittance sequentially where the JAX scan forms prefix products, so
only f32 reassociation separates them.  Overflow counters must be equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.ops.blend_kernel import blend_tiles_pallas
from open_diffusiongs_tpu.ops.gaussians import Gaussians as JGaussians
from open_diffusiongs_tpu_torch.ops import blend_kernel, gs_math
from open_diffusiongs_tpu_torch.ops import camera as cam_lib
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.ops.gaussians import Gaussians
from utils3d import orbit_cameras, random_gaussians

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "render_300g_64px.npz")
H = W = 64
ATOL = 2e-5


def _tg(g):
    return Gaussians(*(torch.from_numpy(np.array(x)) for x in g))


def _cams(n, h=H, w=W):
    c2ws, fxy = orbit_cameras(n, h=h, w=w)
    return c2ws[None], fxy[None]


def _render(g, c2w, fxy, cfg, **kw):
    return rz.render(_tg(g), torch.from_numpy(c2w), torch.from_numpy(fxy),
                     H, W, cfg=cfg, **kw)


def test_golden_render():
    """The pinned 300-Gaussian render (inputs of tests/test_golden.py)."""
    rng = np.random.default_rng(42)
    g = random_gaussians(rng, 1, 300, scale_mean=-3.0)
    c2w, fxy = _cams(2)
    out = _render(g, c2w, fxy, rz.RasterizeConfig(32, 256, 32))
    expect = np.load(GOLDEN)
    np.testing.assert_allclose(out["render"].numpy(), expect["render"],
                               atol=ATOL)
    np.testing.assert_allclose(out["alpha"].numpy(), expect["alpha"],
                               atol=ATOL)


@pytest.mark.parametrize("rect_clip", ["center", "first"])
def test_render_matches_jax_with_both_caps_firing(rng, rect_clip):
    """Init-statistics footprints (rects far over D = 4 tiles) and K = 24:
    the rect clip and both overflow counters fire, and every output and
    counter must agree with the JAX render."""
    g = random_gaussians(rng, 1, 160, scale_mean=-1.3)
    c2w, fxy = _cams(2)
    cfg = dict(max_tiles_per_gaussian=4, max_per_tile=24,
               rect_clip=rect_clip)
    ref = jrz.render(JGaussians(*(jnp.asarray(x) for x in g)),
                     jnp.asarray(c2w), jnp.asarray(fxy), H, W,
                     bg_color=(0.1, 0.2, 0.3),
                     cfg=jrz.RasterizeConfig(**cfg))
    out = _render(g, c2w, fxy, rz.RasterizeConfig(**cfg),
                  bg_color=(0.1, 0.2, 0.3))
    for key in ("overflow_tiles", "overflow_gaussians", "binned_entries"):
        assert int(out[key]) == int(ref[key]), key
    assert int(out["overflow_tiles"]) > 0
    assert int(out["overflow_gaussians"]) > 0
    np.testing.assert_allclose(out["render"].numpy(),
                               np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(out["alpha"].numpy(),
                               np.asarray(ref["alpha"]), atol=ATOL)
    # depth accumulates view-space z (~3): the same relative bar
    np.testing.assert_allclose(out["depth"].numpy(),
                               np.asarray(ref["depth"]), atol=1e-4)


def _binned_view(rng, n=120, scale_mean=-2.0, k=100):
    """One view of a random scene, preprocessed and binned by the port."""
    g = _tg(random_gaussians(rng, 1, n, scale_mean=scale_mean))
    c2w, fxy = orbit_cameras(1, h=H, w=W)
    act = Gaussians(*(x[0] for x in g)).activate()
    cam = cam_lib.CameraParams(*(x[0] for x in cam_lib.make_camera(
        torch.from_numpy(c2w), torch.from_numpy(fxy), H, W)))
    pre = rz.preprocess_view(act, gs_math.build_cov3d(act.scaling,
                                                      act.rotation),
                             cam, H, W, g.sh_degree)
    pre, _ = rz._clip_rect_centered(pre, 16)
    bins = rz._bin_tiles_single(pre, W // 16, H // 16,
                                rz.RasterizeConfig(16, k, 32))
    return rz.pack_rows(pre), bins


def test_blend_ref_matches_jax_pallas_kernel(rng):
    """blend_tiles_ref vs the TPU kernel (interpret mode) on the same
    candidate rows: g = packed[idx], padded with zero rows to Kp = 128."""
    packed, bins = _binned_view(rng)
    assert int(bins.counts.max()) > 10
    g = packed[bins.idx.long()].numpy()
    g = np.concatenate(
        [g, np.zeros((g.shape[0], 128 - g.shape[1], 10), np.float32)], 1)
    ref = blend_tiles_pallas(jnp.asarray(g), jnp.asarray(bins.counts.numpy()),
                             W // 16, interpret=True)
    ours = blend_kernel.blend_tiles_ref(packed, bins.idx, bins.counts, W // 16)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_blend_wrapper_on_cpu_is_the_plain_version(rng):
    packed, bins = _binned_view(rng, k=64)
    before = blend_kernel.LAUNCHES
    out = blend_kernel.blend_tiles(packed, bins.idx, bins.counts, W // 16)
    ref = blend_kernel.blend_tiles_ref(packed, bins.idx, bins.counts, W // 16)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert blend_kernel.LAUNCHES == before == 0
    with pytest.raises(ValueError):
        blend_kernel.blend_tiles(packed[:, :9], bins.idx, bins.counts, 4)


def test_binning_is_depth_sorted_with_stable_ties():
    """Candidates come out nearest first, equal depths by index (the
    stable radix order), and slots beyond counts hold the sentinel N."""
    n = 6
    pre = rz.PreprocessedView(
        xy=torch.full((n, 2), 8.0), depth=torch.tensor(
            [3.0, 1.0, 2.0, 1.0, 5.0, 2.0]),
        conic=torch.ones(n, 3), color=torch.ones(n, 3),
        opacity=torch.ones(n), valid=torch.tensor([1, 1, 1, 1, 0, 1]).bool(),
        rect=torch.tensor([[0, 0, 1, 1]] * n, dtype=torch.int32))
    bins = rz._bin_tiles_single(pre, 2, 2, rz.RasterizeConfig(4, 8, 32))
    assert bins.counts.tolist() == [5, 0, 0, 0]
    assert bins.idx[0].tolist() == [1, 3, 2, 5, 0, 6, 6, 6]
    assert int(bins.entries) == 5 and int(bins.overflow_gaussians) == 0


def test_background_only():
    g = JGaussians(
        xyz=np.zeros((1, 2, 3), np.float32),
        features=np.zeros((1, 2, 1, 3), np.float32),
        scaling=np.full((1, 2, 3), -3.0, np.float32),
        rotation=np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (1, 2, 1)),
        opacity=np.full((1, 2, 1), -100.0, np.float32))   # sigmoid -> 0
    c2w, fxy = _cams(1)
    out = _render(g, c2w, fxy, rz.RasterizeConfig(16, 64, 32),
                  bg_color=(0.2, 0.4, 0.6))
    img = out["render"][0, 0].numpy()
    for c, bg in enumerate((0.2, 0.4, 0.6)):
        np.testing.assert_allclose(img[c], bg, atol=1e-6)
    np.testing.assert_allclose(out["alpha"].numpy(), 0.0, atol=1e-6)


def test_opaque_center_gaussian():
    feat = (np.ones(3, np.float32) - 0.5) / gs_math.SH_C0   # white
    g = JGaussians(
        xyz=np.zeros((1, 1, 3), np.float32),
        features=feat[None, None, None, :].astype(np.float32),
        scaling=np.full((1, 1, 3), np.log(0.3), np.float32),
        rotation=np.asarray([1.0, 0, 0, 0], np.float32)[None, None, :],
        opacity=np.full((1, 1, 1), 20.0, np.float32))
    c2w, fxy = _cams(1)
    out = _render(g, c2w, fxy, rz.RasterizeConfig(16, 64, 32),
                  bg_color=(0.0, 0.0, 0.0))
    img = out["render"][0, 0].numpy()
    assert img[:, H // 2, W // 2].min() > 0.98     # alpha caps at 0.99
    assert float(out["alpha"][0, 0, 0, H // 2, W // 2]) > 0.98
    assert img[:, 0, 0].max() < 0.05               # corners: background
