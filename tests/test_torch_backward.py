"""PyTorch port vs the JAX package: the backward of the object training path.

  * the stats forward's lse and `flash_mha_packed_bwd_ref` (the plain twins
    of the CUDA kernels flash_attn_fwd.cu / flash_attn_bwd.cu) against the
    JAX Pallas `flash_mha_packed(with_stats=True)` and
    `flash_mha_packed_bwd` in interpret mode, same numpy inputs in f32,
    ragged (l_real < Lp), blocks of 128.  Bar: atol 2e-4 / rtol 1e-3 (the
    f32 attention bar of tests/test_attention.py:331-349, 418-443); pad-row
    gradients exactly 0;
  * `blend_bwd_ref` (the plain twin of blend_bwd.cu) against the JAX
    Pallas `blend_bwd_pallas` in interpret mode.  Bar: atol 2e-5 / rtol
    2e-4 (tests/test_rasterize.py:307-326); bounded by the forward's end
    slots it gives the same rows bit for bit;
  * the port's `render` gradients with respect to the raw Gaussians against
    jax.grad of the JAX render, K >= N, centred clip.  Bar: atol 5e-4 of
    each field's largest gradient (tests/test_rasterize.py:114-132); two
    backward runs bit-identical;
  * the autograd Functions (the repair of the silent gradient cut: before
    them the CUDA outputs carried no grad_fn) against autograd through the
    plain twins, and the DiT / render graphs running through them.
The kernels themselves are held against the plain twins on the GPU by
chip_smoke.py (phases 6 and 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.ops.attention import flash_mha_packed as jax_fwd
from open_diffusiongs_tpu.ops.attention import \
    flash_mha_packed_bwd as jax_bwd
from open_diffusiongs_tpu.ops.blend_kernel import blend_bwd_pallas
from open_diffusiongs_tpu.ops.gaussians import Gaussians as JGaussians
from open_diffusiongs_tpu_torch.models.transformer import Attention
from open_diffusiongs_tpu_torch.ops import attention, blend_kernel, gs_math
from open_diffusiongs_tpu_torch.ops import camera as cam_lib
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.ops.gaussians import Gaussians
from utils3d import orbit_cameras, random_gaussians

ATTN_TOL = dict(atol=2e-4, rtol=1e-3)
BLEND_TOL = dict(atol=2e-5, rtol=2e-4)
H = W = 32


def _attn_inputs(rng, b, l, lp, hd):
    """q, k, v, dO [b, Lp, hd] f32; pad rows of all four hold N(0, 1)
    garbage (the wrappers mask dO)."""
    return rng.normal(size=(4, b, lp, hd)).astype(np.float32)


@pytest.mark.parametrize("h,dh", [(2, 64), (4, 32), (8, 16)])
def test_stats_forward_and_backward_ref_match_jax_kernels(h, dh):
    rng = np.random.default_rng(11 + dh)
    b, l, lp = 1, 300, 384
    q, k, v, do = _attn_inputs(rng, b, l, lp, h * dh)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = jax_fwd(jq, jk, jv, num_heads=h, l_real=l, blocks=(128, 128),
                       with_stats=True, interpret=True)
    jgrads = jax_bwd(jq, jk, jv, jo, jdo, jlse, num_heads=h, l_real=l,
                     blocks=(128, 128), interpret=True)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = attention.flash_mha_packed(tq, tk, tv, num_heads=h, l_real=l,
                                        with_stats=True)
    assert lse.shape == (b, lp, h) and lse.dtype == torch.float32
    np.testing.assert_allclose(o[:, :l].numpy(), np.asarray(jo)[:, :l],
                               **ATTN_TOL)
    np.testing.assert_allclose(lse[:, :l].numpy(), np.asarray(jlse)[:, :l],
                               **ATTN_TOL)
    assert not lse[:, l:].any()
    grads = attention.flash_mha_packed_bwd(tq, tk, tv, o, tdo, lse,
                                           num_heads=h, l_real=l)
    for name, g, r in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **ATTN_TOL,
                                   err_msg=f"d{name}")
        assert not g[:, l:].any(), f"d{name} pad rows"


def test_backward_ref_ignores_huge_pad_garbage():
    """1e4 in the pad rows of q/k/v and dO moves nothing on the real
    rows and leaves the pad-row gradients exactly 0."""
    rng = np.random.default_rng(4)
    b, l, lp, h, dh = 1, 100, 128, 2, 32
    base = torch.from_numpy(_attn_inputs(rng, b, l, lp, h * dh))
    dirty = base.clone()
    dirty[:, :, l:] = 1e4
    outs = []
    for q, k, v, do in (base, dirty):
        o, lse = attention.flash_mha_packed(q, k, v, num_heads=h, l_real=l,
                                            with_stats=True)
        outs.append(attention.flash_mha_packed_bwd(q, k, v, o, do, lse,
                                                   num_heads=h, l_real=l))
    for g_clean, g_dirty in zip(*outs):
        assert torch.isfinite(g_dirty).all()
        assert not g_dirty[:, l:].any()
        np.testing.assert_allclose(g_dirty[:, :l].numpy(),
                                   g_clean[:, :l].numpy(), **ATTN_TOL)


def test_attention_function_matches_autograd_of_plain_twin():
    """FlashMHAPacked (stats forward + backward) on a fused qkv vs autograd
    through flash_mha_packed_ref; the gradient comes back as one fused
    [b, L, 3*h*dh] tensor."""
    rng = np.random.default_rng(5)
    b, l, lp, h, dh = 2, 90, 128, 2, 32
    qkv = torch.from_numpy(rng.normal(size=(b, lp, 3 * h * dh))
                           .astype(np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rng.normal(size=(b, l, h * dh)).astype(np.float32))
    o = attention.flash_attention(qkv, num_heads=h, l_real=l)
    assert type(o.grad_fn).__name__ == "FlashMHAPackedBackward"
    (got,) = torch.autograd.grad((o[:, :l] * cot).sum(), qkv)
    ref_o = attention.flash_mha_packed_ref(*qkv.chunk(3, -1), num_heads=h,
                                           l_real=l)
    (want,) = torch.autograd.grad((ref_o[:, :l] * cot).sum(), qkv)
    assert got.shape == qkv.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATTN_TOL)
    assert not got[:, l:].any()
    with torch.no_grad():                 # sampling keeps the stats-free path
        assert attention.flash_attention(qkv, num_heads=h,
                                         l_real=l).grad_fn is None


def test_dit_attention_layer_reaches_qkv_weights():
    """The DiT's Attention routes through the Function: every qkv weight
    gets a gradient (the fault this PR repairs left it None on CUDA).  A
    packed layout (4 heads of 32; 2 heads of 32 take the general route)."""
    torch.manual_seed(0)
    layer = Attention(128, 4)
    assert layer.packed
    x = torch.randn(2, 40, 128)
    layer(x).square().mean().backward()
    assert layer.qkv.weight.grad is not None
    assert layer.qkv.weight.grad.abs().sum() > 0


def _binned_view(rng, n=200, k=256, scale_mean=-2.5):
    g = random_gaussians(rng, 1, n, scale_mean=scale_mean)
    act = Gaussians(*(torch.from_numpy(np.array(x[0])) for x in g)
                    ).activate()
    c2ws, fxy = orbit_cameras(1, h=H, w=W)
    cam = cam_lib.CameraParams(*(x[0] for x in cam_lib.make_camera(
        torch.from_numpy(c2ws), torch.from_numpy(fxy), H, W)))
    pre = rz.preprocess_view(act, gs_math.build_cov3d(act.scaling,
                                                      act.rotation),
                             cam, H, W, g.sh_degree)
    pre, _ = rz._clip_rect_centered(pre, 16)
    bins = rz._bin_tiles_single(pre, W // 16, H // 16,
                                rz.RasterizeConfig(16, k, 32), grad_map=True)
    return rz.pack_rows(pre), bins


def _cotangents(rng, num_tiles):
    return (torch.from_numpy(rng.normal(size=(num_tiles, 256))
                             .astype(np.float32)),
            torch.from_numpy(rng.normal(size=(num_tiles, 256, 3))
                             .astype(np.float32)),
            torch.from_numpy(rng.normal(size=(num_tiles, 256))
                             .astype(np.float32)))


def test_blend_bwd_ref_matches_jax_pallas_kernel(rng):
    packed, bins = _binned_view(rng)
    assert int(bins.counts.max()) > 10
    fwd = blend_kernel.blend_tiles(packed, bins.idx, bins.counts, W // 16)
    cot = _cotangents(rng, bins.idx.shape[0])
    ours = blend_kernel.blend_bwd(packed, bins.idx, bins.counts, *fwd, *cot,
                                  W // 16)
    assert ours.shape == (bins.idx.shape[0], 256, 10)

    def pack8(c3, s1, s2):                                 # -> [T, 8, 256]
        t = c3.shape[0]
        return np.concatenate([c3.numpy().transpose(0, 2, 1),
                               s1.numpy()[:, None], s2.numpy()[:, None],
                               np.zeros((t, 3, 256), np.float32)], 1)

    g = packed[bins.idx.long()].numpy()                    # K = 256 = Kp
    ref = blend_bwd_pallas(jnp.asarray(g), jnp.asarray(bins.counts.numpy()),
                           jnp.asarray(pack8(fwd[1], fwd[0], fwd[2])),
                           jnp.asarray(pack8(cot[1], cot[0], cot[2])),
                           W // 16, interpret=True)
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BLEND_TOL)


def test_blend_function_matches_autograd_of_plain_twin(rng):
    """BlendTiles' gradient on the packed table (backward + the gather-sum
    through gidx) vs autograd through blend_tiles_ref."""
    packed, bins = _binned_view(rng)
    cot = _cotangents(rng, bins.idx.shape[0])

    def grad(fn):
        p = packed.clone().requires_grad_(True)
        out = fn(p)
        return torch.autograd.grad(sum((o * c).sum() for o, c in
                                       zip(out, cot)), p)[0]

    got = grad(lambda p: blend_kernel.BlendTiles.apply(
        p, bins.idx, bins.counts, bins.gidx, W // 16))
    want = grad(lambda p: blend_kernel.blend_tiles_ref(
        p, bins.idx, bins.counts, W // 16))
    assert want.abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BLEND_TOL)


def test_gather_map_inverts_the_binning():
    """gidx sends every binned (slot, Gaussian) entry to the candidate slot
    that holds that Gaussian, and nothing else anywhere."""
    packed, bins = _binned_view(np.random.default_rng(3), n=120, k=24)
    t_k = bins.idx.numel()
    n = packed.shape[0] - 1
    flat_idx = bins.idx.reshape(-1).long()
    g = bins.gidx.long()
    hit = g < t_k
    assert hit.any() and (~hit).any()
    assert torch.equal(flat_idx[g[hit]],
                       torch.arange(n).expand_as(g)[hit])
    # every live candidate slot is reached by exactly one (slot, Gaussian)
    live = torch.arange(bins.idx.shape[1])[None] < bins.counts[:, None]
    reached = torch.bincount(g[hit], minlength=t_k).reshape(bins.idx.shape)
    assert torch.equal(reached, live.long())


def _jax_render_loss(g, c2w, fxy, target, cfg):
    out = jrz.render(g, c2w, fxy, H, W, cfg=cfg)
    return (jnp.mean((out["render"] - target) ** 2)
            + 0.7 * jnp.mean(out["alpha"] ** 2)
            + 0.3 * jnp.mean(out["depth"] ** 2))


def test_render_gradients_match_jax_and_are_deterministic(rng):
    g = random_gaussians(rng, 1, 200, scale_mean=-2.5)
    c2ws, fxy = orbit_cameras(2, h=H, w=W)
    target = rng.uniform(size=(1, 2, 3, H, W)).astype(np.float32)
    cfg = dict(max_tiles_per_gaussian=16, max_per_tile=256,
               rect_clip="center")
    jg = JGaussians(*(jnp.asarray(x) for x in g))
    ref = jax.grad(_jax_render_loss)(jg, jnp.asarray(c2ws)[None],
                                     jnp.asarray(fxy)[None],
                                     jnp.asarray(target),
                                     jrz.RasterizeConfig(**cfg))

    def grads():
        tg = Gaussians(*(torch.from_numpy(np.array(x)).requires_grad_(True)
                         for x in g))
        out = rz.render(tg, torch.from_numpy(c2ws)[None],
                        torch.from_numpy(fxy)[None], H, W,
                        cfg=rz.RasterizeConfig(**cfg))
        assert int(out["overflow_gaussians"]) == 0
        loss = (((out["render"] - torch.from_numpy(target)) ** 2).mean()
                + 0.7 * (out["alpha"] ** 2).mean()
                + 0.3 * (out["depth"] ** 2).mean())
        return torch.autograd.grad(loss, list(tg))

    first, second = grads(), grads()
    for name, a, b, r in zip(g._fields, first, second, ref):
        assert torch.equal(a, b), f"{name}: two backward runs differ"
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1e-8)
        np.testing.assert_allclose(a.numpy() / scale, r / scale, atol=5e-4,
                                   err_msg=name)
    assert first[0].abs().max() > 0


def test_blend_bwd_ref_with_the_forward_end_slots_changes_no_gradient():
    """The end slots the forward returns bound the re-walk and leave every
    gradient row as it was; on a view where pixels stop early."""
    rng = np.random.default_rng(9)
    packed, bins = _binned_view(rng, n=400, scale_mean=-1.6)
    t_fin, acc_c, acc_d, n_end = blend_kernel.blend_tiles(
        packed, bins.idx, bins.counts, W // 16, return_end=True)
    assert (n_end < bins.counts[:, None]).any()
    cot = _cotangents(rng, bins.idx.shape[0])
    args = (packed, bins.idx, bins.counts, t_fin, acc_c, acc_d, *cot, W // 16)
    free = blend_kernel.blend_bwd_ref(*args)
    bounded = blend_kernel.blend_bwd_ref(*args, n_end=n_end)
    assert free.abs().max() > 0
    assert torch.equal(bounded, free)
    assert torch.equal(blend_kernel.blend_bwd(*args, n_end=n_end), free)
