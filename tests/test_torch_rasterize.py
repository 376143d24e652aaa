"""PyTorch port vs the JAX package: the rasterizer forward.

On CPU tensors the port's `render` blends through `blend_tiles_ref`, the
plain twin of the CUDA blend kernel (chip_smoke.py phase 4 holds the kernel
against it on the GPU).  Bars: atol 2e-5, the rasterizer forward bar of
tests/test_rasterize.py and tests/test_golden.py — the port multiplies the
transmittance sequentially where the JAX scan forms prefix products, so
only f32 reassociation separates them.  Overflow counters must be equal.

Also the blend kernels' host-side rules: their conservative cull
(`blend_kernel.misses_rect`, the f32 mirror of csrc/blend.cuh) never skips
a (candidate, warp rectangle) pair holding a pixel that blends the
candidate, over edge cases and at trained statistics; the forward's
per-pixel end slot from the plain twin equals a direct sequential walk's;
and chip_smoke.py's blend accounting (the pairs its bounds count, its
end-slot gate) reads what the twin's walk gives.
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


def _pixel_passes(rows, px, py):
    """[..., P] whether each pixel centre blends the candidate row under
    the kernels' skip test (power <= 0 and alpha >= 1/255), in f32 as the
    kernel orders it and in f64 (the order an FMA-contracted build comes
    near); a conservative cull must hold for both."""
    out = []
    for dt in (torch.float32, torch.float64):
        a = rows.to(dt)[..., None, :]
        dx = a[..., 0] - px.to(dt)
        dy = a[..., 1] - py.to(dt)
        power = (-0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy)
                 - a[..., 3] * dx * dy)
        alpha = torch.clamp(a[..., 8] * torch.exp(power), max=0.99)
        out.append((power <= 0) & (alpha >= torch.tensor(
            blend_kernel.ALPHA_MIN, dtype=torch.float32).to(dt)))
    return out[0] | out[1]


def _cull_population(rng, n):
    """[n, 10] candidate rows against tile 0 of a 16-px-wide image: PD
    conics from sigmas 0.05-40 px at random angles, near-singular conics
    (det down to ~1e-7 of a c), non-PD and negative conics; opacities
    at, just below and just above 1/255, uniform, 0.99 and 1; means on
    and far off the tile."""
    sig = np.exp(rng.uniform(np.log(0.05), np.log(40.0), (n, 2)))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    cov = rot @ (sig[:, :, None] ** 2 * np.eye(2)) @ rot.transpose(0, 2, 1)
    conic = np.linalg.inv(cov)
    a, b, cc = conic[:, 0, 0], conic[:, 0, 1], conic[:, 1, 1]
    kind = rng.integers(0, 6, n)
    near = kind == 1              # b^2 -> a c from below
    b = np.where(near, np.sign(b + 1e-30) * np.sqrt(a * cc)
                 * (1 - 10.0 ** rng.uniform(-7, -2, n)), b)
    b = np.where(kind == 2, np.sqrt(a * cc) * rng.uniform(1.0, 3.0, n), b)
    a = np.where(kind == 3, -a, a)
    cc = np.where(kind == 3, -cc, cc)
    amin = np.float32(1.0) / np.float32(255.0)
    o = rng.choice(np.array([amin, np.nextafter(amin, np.float32(0)),
                             np.nextafter(amin, np.float32(1)), 0.99, 1.0,
                             0.0], np.float32), n)
    o = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0, 1, n), o)
    far = rng.uniform(size=n) < 0.2
    xy = np.where(far[:, None], rng.uniform(-2e4, 2e4, (n, 2)),
                  rng.uniform(-60, 76, (n, 2)))
    # a quarter sit with their ellipse's x-extreme within ~1e-6 of a
    # pixel centre on the right edge of a warp rectangle (ellipse of the
    # exact rule Q <= 2 ln(255 o), the PD conics of kind 0)
    edge = (kind == 0) & (rng.uniform(size=n) < 0.5)
    o = np.where(edge, rng.uniform(0.01, 1.0, n), o).astype(np.float32)
    det = a * cc - b * b
    q = 2 * np.log(255.0 * np.where(edge, o, 1.0).astype(np.float64))
    hx = np.sqrt(np.abs(q * cc / det))
    eps = rng.uniform(-1e-6, 1e-6, n)
    px = rng.choice([7.0, 15.0], n)
    py = rng.integers(0, 16, n).astype(np.float64)
    xy[:, 0] = np.where(edge, px + hx * (1 + eps), xy[:, 0])
    xy[:, 1] = np.where(edge, py - b / cc * hx * (1 + eps), xy[:, 1])
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0:2] = xy
    rows[:, 2], rows[:, 3], rows[:, 4] = a, b, cc
    rows[:, 5:8] = rng.uniform(size=(n, 3))
    rows[:, 8] = o
    rows[:, 9] = rng.uniform(1, 5, n)
    return torch.from_numpy(rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_is_conservative(seed):
    """No (candidate, warp rectangle) pair the kernels' cull skips holds a
    pixel that would blend the candidate."""
    rows = _cull_population(np.random.default_rng(seed), 4000)
    rects = blend_kernel.warp_rects(1, 1)[0]                 # [8, 4]
    culled = blend_kernel.misses_rect(rows[:, None], rects[None])   # [n, 8]
    pix = blend_kernel.warp_pixels()                         # [8, 32]
    px, py = (pix % 16).float(), (pix // 16).float()
    passes = _pixel_passes(rows[:, None, :], px[None], py[None])  # [n,8,32]
    assert not (culled & passes.any(-1)).any()
    # the test population exercises both sides of the rule
    assert culled.float().mean() > 0.3
    assert (passes.any(-1) & ~culled).float().mean() > 0.02
    near = ~culled & ~passes.any(-1)       # kept though it blends nothing
    assert near.any()


def test_cull_removes_most_pairs_at_trained_statistics():
    """Trained statistics (bench.py:43-51: ~1.5 px footprints, opacity
    ~ sigmoid(1)): candidates binned to a tile by their 3-sigma rect; the
    cull removes most (candidate, warp rectangle) pairs, and each removed
    pair is one no pixel of the rectangle blends."""
    rng = np.random.default_rng(5)
    n = 4000
    sig = rng.uniform(1.0, 2.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    cov = rot @ (sig[:, :, None] ** 2 * np.eye(2)) @ rot.transpose(0, 2, 1)
    conic = np.linalg.inv(cov)
    r3 = 3 * sig.max(-1)
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0] = rng.uniform(-r3, 15 + r3)
    rows[:, 1] = rng.uniform(-r3, 15 + r3)
    rows[:, 2], rows[:, 3], rows[:, 4] = (conic[:, 0, 0], conic[:, 0, 1],
                                          conic[:, 1, 1])
    rows[:, 8] = 1 / (1 + np.exp(-rng.normal(1.0, 0.3, n)))
    rows = torch.from_numpy(rows)
    rects = blend_kernel.warp_rects(1, 1)[0]
    culled = blend_kernel.misses_rect(rows[:, None], rects[None])
    pix = blend_kernel.warp_pixels()
    passes = _pixel_passes(rows[:, None, :], (pix % 16).float()[None],
                           (pix // 16).float()[None])
    assert not (culled & passes.any(-1)).any()
    assert culled.float().mean() > 0.5


def test_warp_rectangles_tile_the_tile():
    pix = blend_kernel.warp_pixels()
    assert sorted(pix.reshape(-1).tolist()) == list(range(256))
    rects = blend_kernel.warp_rects(6, 3)                    # [6, 8, 4]
    for t in range(6):
        for w in range(8):
            x0, y0, x1, y1 = rects[t, w].tolist()
            px = (t % 3) * 16 + pix[w] % 16
            py = (t // 3) * 16 + pix[w] // 16
            assert (int(px.min()), int(py.min()), int(px.max()),
                    int(py.max())) == (x0, y0, x1, y1)


def test_cull_mask_skips_no_live_pair_of_a_view(rng):
    """On a binned view, every (slot, warp) pair cull_mask marks is one no
    pixel of the warp blends, and slots past counts read False."""
    packed, bins = _binned_view(rng, n=300, scale_mean=-3.0)
    mask = blend_kernel.cull_mask(packed, bins.idx, bins.counts, W // 16)
    t, k = bins.idx.shape
    assert mask.shape == (t, 8, k) and mask.any()
    live = torch.arange(k) < bins.counts[:, None]
    assert not (mask & ~live[:, None]).any()
    rows = packed[bins.idx.long()]                           # [T, K, 10]
    pix = blend_kernel.warp_pixels()
    tx = (torch.arange(t) % (W // 16)) * 16
    ty = (torch.arange(t) // (W // 16)) * 16
    px = (tx[:, None, None] + pix % 16).float()              # [T, 8, 32]
    py = (ty[:, None, None] + pix // 16).float()
    passes = _pixel_passes(rows[:, None, :, :], px[:, :, None],
                           py[:, :, None])                   # [T, 8, K, 32]
    assert not (mask & passes.any(-1)).any()


def _end_by_pixel_loop(packed, idx, counts, tiles_x):
    """Each pixel's stopping slot (or counts[t]) by a direct sequential
    walk: T multiplied candidate by candidate in f32, as the kernel does."""
    t_n, k = idx.shape
    rows = packed[idx.long()].numpy()
    pix = np.arange(256)
    px = ((np.arange(t_n) % tiles_x) * 16)[:, None] + pix % 16
    py = ((np.arange(t_n) // tiles_x) * 16)[:, None] + pix // 16
    px, py = px.astype(np.float32), py.astype(np.float32)
    tr = np.ones((t_n, 256), np.float32)
    end = np.repeat(counts.numpy()[:, None], 256, 1).astype(np.int32)
    done = np.zeros((t_n, 256), bool)
    f = np.float32
    for j in range(k):
        a = rows[:, j]
        dx = a[:, 0:1] - px
        dy = a[:, 1:2] - py
        power = (f(-0.5) * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy)
                 - a[:, 3:4] * dx * dy)
        alpha = np.minimum(f(0.99), a[:, 8:9] * np.exp(power))
        ok = ((j < counts.numpy())[:, None] & (power <= 0)
              & (alpha >= f(blend_kernel.ALPHA_MIN)) & ~done)
        test_t = tr * (f(1) - alpha)
        stop = ok & (test_t < f(blend_kernel.EARLY_STOP_T))
        end = np.where(stop, j, end)
        done |= stop
        tr = np.where(ok & ~stop, test_t, tr)
    return end


def test_blend_ref_end_slot_matches_a_pixel_loop(rng):
    packed, bins = _binned_view(rng, n=400, scale_mean=-1.6, k=200)
    out = blend_kernel.blend_tiles_ref(packed, bins.idx, bins.counts, W // 16,
                                       return_end=True)
    end = out[3]
    assert end.dtype == torch.int32 and end.shape == (bins.idx.shape[0], 256)
    want = _end_by_pixel_loop(packed, bins.idx, bins.counts, W // 16)
    np.testing.assert_array_equal(end.numpy(), want)
    stopped = end < bins.counts[:, None]
    assert stopped.any() and (~stopped).any()
    # the three outputs are the plain call's
    for a, b in zip(out[:3], blend_kernel.blend_tiles_ref(
            packed, bins.idx, bins.counts, W // 16)):
        assert torch.equal(a, b)
    # the CPU wrapper hands the same end slots back
    got = blend_kernel.blend_tiles(packed, bins.idx, bins.counts, W // 16,
                                   return_end=True)
    assert torch.equal(got[3], end)


def test_chip_smoke_blend_walk_counts_the_twins_pairs(rng):
    """The pairs chip_smoke.py's blend bounds are computed from: examined
    pairs (through each pixel's end slot), rows read (per tile through its
    deepest pixel) and live pairs (those blended) equal the plain twin's
    own walk on a binned view."""
    import chip_smoke
    packed, bins = _binned_view(rng, n=400, scale_mean=-1.6, k=200)
    walk = blend_kernel._Walk(packed, bins.idx, bins.counts, W // 16)
    live = sum(int(ch.contrib.sum()) for _, ch in walk)
    counts = bins.counts[:, None]
    examined = torch.where(walk.end < counts, walk.end + 1, counts)
    got = chip_smoke.blend_walk(torch, packed, bins.idx, bins.counts, W // 16)
    assert got == (int(examined.sum()), int(examined.amax(-1).sum()), live)
    assert 0 < live < got[0]


def test_chip_smoke_end_slot_gate_reads_the_stop_distance(rng):
    """chip_smoke.py's end-slot gate reads, at a pixel whose end slots
    differ, |T (1 - alpha) - 1e-4| / 1e-4 at the earlier slot: at a real
    stop that is the twin's final T times (1 - alpha) of the stopping
    candidate; equal end slots give nothing to read."""
    import chip_smoke
    packed, bins = _binned_view(rng, n=400, scale_mean=-1.6, k=200)
    tiles_x = W // 16
    view = {"packed": packed, "bins": bins, "tiles_x": tiles_x}
    t_fin, _, _, end = blend_kernel.blend_tiles_ref(
        packed, bins.idx, bins.counts, tiles_x, return_end=True)
    assert chip_smoke.end_slot_flips(torch, view, end, end) == []
    stopped = (end < bins.counts[:, None]).nonzero().tolist()[::97]
    assert len(stopped) > 5
    wrong = end.clone()
    for t, p in stopped:
        wrong[t, p] += 1
    gaps = chip_smoke.end_slot_flips(torch, view, wrong, end)
    want = []
    for t, p in stopped:
        a = packed[bins.idx[t, end[t, p]].long()].double()
        dx = float(a[0]) - ((t % tiles_x) * 16 + p % 16)
        dy = float(a[1]) - ((t // tiles_x) * 16 + p // 16)
        power = (-0.5 * (float(a[2]) * dx * dx + float(a[4]) * dy * dy)
                 - float(a[3]) * dx * dy)
        alpha = min(blend_kernel.ALPHA_MAX, float(a[8]) * np.exp(power))
        want.append(abs(float(t_fin[t, p]) * (1 - alpha) - 1e-4) / 1e-4)
    np.testing.assert_allclose(gaps, want, atol=1e-4)
    assert all(0 <= g <= 1 for g in gaps)
