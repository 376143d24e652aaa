"""The port's sequence parallelism (parallel/ring.py) in gloo processes on
the CPU against the JAX package's ring on the conftest's virtual CPU mesh.

One world of 4 processes (tests/torch_dist.py::ring_cases) runs, with the
packed kernels' plain twins:
  * ring attention at sp = 4 (pad keys spanning two shards, one shard all
    padding) and dp = 2 x sp = 2, against JAX `make_ring_attention` (XLA
    path, f32): forward atol 2e-5 / rtol 1e-4, gradients of
    sum(out[:, :l_real]^2) atol 3e-5 / rtol 1e-3 (tests/test_ring.py:40-105);
  * a DiTStack (2 layers, 4 heads of 64: the packed route, under block
    checkpointing) and a qk_norm DiTBlock (4 heads of 32: k and v gathered
    over the ring, the general route's twins with lq != lk) at dp = 2 x
    sp = 2, against JAX's DiTStack with `sp_mesh` and JAX's block: output
    atol 2e-4 / rtol 1e-3, parameter gradients (summed over the world and
    divided by sp, the seq axis' rule) atol 2e-4 / rtol 1e-2
    (tests/test_ring.py:123-161);
  * a tiny denoiser (3 views of 80², 302 tokens padded to 512: one full
    shard, one of 46 real rows) at dp = 2 x sp = 2 against JAX's
    DGSDenoiser with `sp_mesh` (xyz and opacity atol 2e-4 / rtol 1e-3,
    tests/test_ring.py:164-188).
Also the split-extent twins (the ring's two kernels with lq_real != lk_real)
against the JAX Pallas forward in interpret mode and jax.vjp of XLA
attention, and the shard extents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.models import transformer as jtr
from open_diffusiongs_tpu.models.denoiser import DGSDenoiser as JDenoiser
from open_diffusiongs_tpu.ops.attention import flash_mha_packed as jax_fwd
from open_diffusiongs_tpu.ops.rays import rays_chw
from open_diffusiongs_tpu.parallel.mesh import make_mesh
from open_diffusiongs_tpu.parallel.ring import make_ring_attention
from open_diffusiongs_tpu_torch.ops import attention
from open_diffusiongs_tpu_torch.parallel.ring import shard_extent
from open_diffusiongs_tpu_torch.utils.convert import (
    _block_state, block_state_dict_from_flax, flatten_params,
    state_dict_from_flax)
from torch_dist import ring_cases, run_world
from utils3d import orbit_cameras

FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=3e-5, rtol=1e-3)
MOD_TOL = dict(atol=2e-4, rtol=1e-3)
MOD_GRAD_TOL = dict(atol=2e-4, rtol=1e-2)


def _qkv(seed, b, lp, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, lp, hd)).astype(np.float32)
                 for _ in range(3))


def _jax_ring(mesh, q, k, v, dh, l_real, grad=False):
    f = make_ring_attention(mesh, dh=dh, l_real=l_real)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    with mesh:
        out = jax.jit(f)(*args)
        if not grad:
            return np.asarray(out)
        g = jax.jit(jax.grad(lambda a, b_, c: jnp.sum(
            f(a, b_, c)[:, :l_real] ** 2), argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(x) for x in g]


def _perturbed(params, rng):
    return jax.tree.map(lambda p: p + 0.05 * jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)


def _stack_sd(params):
    """JAX DiTStack params ([L, ...] stacked) -> the port's DiTStack."""
    flat = flatten_params(jax.device_get(params))
    pre = "layers/block/"
    n = flat[pre + "attn/q/kernel"].shape[0]
    sd = {}
    for i in range(n):
        block = {k[len(pre):]: v[i] for k, v in flat.items()}
        sd.update({f"{i}.{name}": torch.tensor(w) for name, w in
                   _block_state(block).items()})
    return sd


def _module_refs(rng, kind, mesh):
    """Inputs, port state dict and JAX outputs / gradients of the stack
    (dp x sp mesh, sp_mesh) or the qk_norm block (plain)."""
    b, l = 2, 300
    width, heads = (256, 4) if kind == "stack" else (128, 4)
    x = rng.normal(size=(b, l, width)).astype(np.float32)
    c = rng.normal(size=(b, width)).astype(np.float32)
    r = rng.normal(size=(b, l, width)).astype(np.float32)
    jx, jc, jr = (jnp.asarray(a) for a in (x, c, r))
    if kind == "stack":
        mod = jtr.DiTStack(hidden_size=width, num_heads=heads, num_layers=2,
                           remat=True, attn_impl="xla", sp_mesh=mesh)
        init = jtr.DiTStack(hidden_size=width, num_heads=heads,
                            num_layers=2, remat=True, attn_impl="xla")
    else:
        mod = init = jtr.DiTBlock(width, heads, qk_norm=True,
                                  attn_impl="xla")
    params = _perturbed(init.init(jax.random.PRNGKey(0), jx, jc), rng)

    def loss(p, x_):
        return jnp.sum(mod.apply(p, x_, jc) * jr)

    with mesh:
        y, (gp, gx) = jax.jit(lambda p, x_: (
            mod.apply(p, x_, jc), jax.grad(loss, argnums=(0, 1))(p, x_)))(
                params, jx)
    to_sd = _stack_sd if kind == "stack" else (
        lambda p: block_state_dict_from_flax(jax.device_get(p)))
    case = dict(x=x, c=c, r=r, width=width, heads=heads, layers=2,
                sd=to_sd(params))
    return case, (np.asarray(y), np.asarray(gx), to_sd(gp))


def _denoiser_refs(rng, mesh):
    kw = dict(width=256, num_layers=2, patch_size=8, dim_heads=64)
    b, v, res = 2, 3, 80
    c2ws, fxy = orbit_cameras(v, h=res, w=res)
    ray_o, ray_d = (np.repeat(np.asarray(x)[None], b, 0) for x in rays_chw(
        jnp.asarray(c2ws), jnp.asarray(fxy), res, res))
    images = rng.uniform(0, 1, (b, v, 3, res, res)).astype(np.float32)
    t = np.asarray([5, 700], np.int32)
    args = tuple(jnp.asarray(a) for a in (images, ray_o, ray_d, t))
    jkw = dict(kw, attn_impl="xla", remat=False, dtype=jnp.float32)
    params = _perturbed(JDenoiser(**jkw).init(jax.random.PRNGKey(0), *args),
                        rng)
    with mesh:
        g, _ = jax.jit(JDenoiser(**jkw, sp_mesh=mesh).apply)(params, *args)
    case = dict(kw=kw, inputs=(images, ray_o, ray_d, t.astype(np.int64)),
                sd=state_dict_from_flax(jax.device_get(params)))
    return case, (np.asarray(g.xyz), np.asarray(g.opacity))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references, then the one world of 4 processes."""
    rng = np.random.default_rng(0)
    mesh4 = make_mesh(jax.devices()[:4], seq_parallel=4)
    mesh22 = make_mesh(jax.devices()[:4], seq_parallel=2)
    inputs, refs = {}, {}
    inputs["fwd"] = (*_qkv(0, 2, 512, 128), 4, 300)
    refs["fwd"] = _jax_ring(mesh4, *inputs["fwd"][:3], 32, 300)
    inputs["grad"] = (*_qkv(3, 2, 512, 64), 2, 450)
    refs["grad"] = _jax_ring(mesh4, *inputs["grad"][:3], 32, 450, grad=True)
    inputs["dp2"] = (*_qkv(2, 2, 512, 64), 2, 400)
    refs["dp2"] = _jax_ring(mesh22, *inputs["dp2"][:3], 32, 400, grad=True)
    for kind in ("stack", "qk_norm"):
        inputs[kind], refs[kind] = _module_refs(rng, kind, mesh22)
    inputs["denoiser"], refs["denoiser"] = _denoiser_refs(rng, mesh22)
    outs = run_world(ring_cases, 4, tmp_path_factory.mktemp("ring"), inputs)
    return inputs, refs, outs


def _rows(outs, key, ranks):
    return np.concatenate([outs[r][key].detach().numpy() for r in ranks], 1)


def test_ring_forward_sp4_matches_jax(world):
    _, refs, outs = world
    got = _rows(outs, "fwd", range(4))
    np.testing.assert_allclose(got[:, :300], refs["fwd"][:, :300], **FWD_TOL)
    assert not got[:, 384:].any()      # the all-pad shard takes no launch


def test_ring_gradients_sp4_match_jax(world):
    _, refs, outs = world
    g = _rows(outs, "grad", range(4))
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(g[..., i * 64:(i + 1) * 64],
                                   refs["grad"][1][i], **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_ring_dp2_sp2_matches_jax(world):
    _, refs, outs = world
    want_o, want_g = refs["dp2"]
    for d in range(2):
        o = np.concatenate([outs[2 * d + s]["dp2"][0].numpy()
                            for s in range(2)], 1)
        g = np.concatenate([outs[2 * d + s]["dp2"][1].numpy()
                            for s in range(2)], 1)
        np.testing.assert_allclose(o[0, :400], want_o[d, :400], **FWD_TOL)
        for i, name in enumerate("qkv"):
            np.testing.assert_allclose(g[0, :, i * 64:(i + 1) * 64],
                                       want_g[i][d], **GRAD_TOL,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("kind", ["stack", "qk_norm"])
def test_dit_under_seq_parallel_matches_jax(world, kind):
    """Output and input gradient of each data row's sample on every seq
    rank; parameter gradients summed over the world and divided by sp."""
    _, refs, outs = world
    want_y, want_gx, want_gp = refs[kind]
    for rank in range(4):
        np.testing.assert_allclose(outs[rank][kind][0][0].numpy(),
                                   want_y[rank // 2], **MOD_TOL)
    for d in range(2):   # a seq rank's part of x's gradient, times sp
        gx = (outs[2 * d][kind][1] + outs[2 * d + 1][kind][1]) / 2
        np.testing.assert_allclose(gx[0].numpy(), want_gx[d],
                                   **MOD_GRAD_TOL)
    names = outs[0][kind][2].keys()
    assert set(names) == set(want_gp)
    for name in names:
        g = sum(outs[r][kind][2][name] for r in range(4)) / 2
        np.testing.assert_allclose(g.numpy(), want_gp[name].numpy(),
                                   err_msg=name, **MOD_GRAD_TOL)


def test_denoiser_under_seq_parallel_matches_jax(world):
    inputs, refs, outs = world
    want_xyz, want_op = refs["denoiser"]
    for rank in range(4):
        xyz, op = outs[rank]["denoiser"]
        d = rank // 2
        np.testing.assert_allclose(xyz[0].numpy(), want_xyz[d], **MOD_TOL)
        np.testing.assert_allclose(op[0].numpy(), want_op[d], **MOD_TOL)


@pytest.mark.parametrize("lq,lk", [(384, 200), (200, 384), (384, 384),
                                   (130, 77)])
def test_split_extent_forward_matches_jax_kernel(lq, lk):
    """#1s's twin with lq_real != lk_real: o and lse of the rows < lq_real
    equal the JAX Pallas kernel's (interpret mode) at l_real = lk_real, which
    writes every row's lse and masks keys only; lse rows >= lq_real are 0."""
    h, dh, lp = 4, 32, 384
    q, k, v = _qkv(7, 1, lp, h * dh)
    jo, jlse = jax_fwd(*(jnp.asarray(x) for x in (q, k, v)), num_heads=h,
                       l_real=lk, blocks=(128, 128), with_stats=True,
                       interpret=True)
    o, lse = attention.flash_mha_packed(
        *(torch.from_numpy(x) for x in (q, k, v)), num_heads=h, lq_real=lq,
        lk_real=lk, with_stats=True)
    np.testing.assert_allclose(o[:, :lq].numpy(), np.asarray(jo)[:, :lq],
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(lse[:, :lq].numpy(),
                               np.asarray(jlse)[:, :lq], atol=2e-4,
                               rtol=1e-3)
    assert not lse[:, lq:].any()


@pytest.mark.parametrize("lq,lk", [(384, 200), (200, 384), (130, 77)])
def test_split_extent_backward_matches_jax_vjp(lq, lk):
    """#3's twin with lq_real != lk_real, fed its forward's lse: dq of the
    rows < lq_real and dk / dv of the keys < lk_real equal jax.vjp of XLA
    attention of q[:lq_real] over k, v[:lk_real]; the other rows are
    exactly 0, with 1e4 garbage in the pad rows of every input."""
    h, dh, lp = 4, 32, 384
    q, k, v = _qkv(8, 1, lp, h * dh)
    do = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    for x, n in ((q, lq), (do, lq), (k, lk), (v, lk)):
        x[:, n:] = 1e4
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = attention.flash_mha_packed(tq, tk, tv, num_heads=h,
                                        lq_real=lq, lk_real=lk,
                                        with_stats=True)
    dq, dk, dv = attention.flash_mha_packed_bwd(
        tq, tk, tv, o, tdo, lse, num_heads=h, lq_real=lq, lk_real=lk)

    def f(a, b_, c):
        four = [x.reshape(1, -1, h, dh) for x in (a, b_, c)]
        return jax.nn.dot_product_attention(*four).reshape(1, -1, h * dh)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in
                          (q[:, :lq], k[:, :lk], v[:, :lk])))
    want = vjp(jnp.asarray(do[:, :lq]))
    for got, ref, n, name in zip((dq, dk, dv), want, (lq, lk, lk), "qkv"):
        np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(ref),
                                   atol=2e-4, rtol=1e-3, err_msg=f"d{name}")
        assert not got[:, n:].any(), f"d{name} past its extent"


@pytest.mark.parametrize("lq,lk", [(384, 200), (130, 77)])
def test_f32_output_rounds_to_the_bf16_output(lq, lk):
    """#1s's twin with `out_f32` (the ring's forward): o in f32 that rounds
    to the bf16 call's o bit for bit, with the same lse."""
    h, lp = 4, 384
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(11, 2, lp, h * 32))
    kw = dict(num_heads=h, lq_real=lq, lk_real=lk, with_stats=True)
    o, lse = attention.flash_mha_packed(q, k, v, **kw)
    o32, lse32 = attention.flash_mha_packed(q, k, v, out_f32=True, **kw)
    assert o32.dtype == torch.float32
    assert torch.equal(o32.to(torch.bfloat16), o)
    assert torch.equal(lse32, lse)


def test_equal_extents_are_the_one_extent_call():
    h, lp, l = 2, 256, 200
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, lp, h * 64))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    one = attention.flash_mha_packed(q, k, v, num_heads=h, l_real=l,
                                     with_stats=True)
    two = attention.flash_mha_packed(q, k, v, num_heads=h, lq_real=l,
                                     lk_real=l, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    g1 = attention.flash_mha_packed_bwd(q, k, v, *one[:1], do, one[1],
                                        num_heads=h, l_real=l)
    g2 = attention.flash_mha_packed_bwd(q, k, v, *one[:1], do, one[1],
                                        num_heads=h, lq_real=l, lk_real=l)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with pytest.raises(ValueError, match="lk_real"):
        attention.flash_mha_packed(q, k, v, num_heads=h, lq_real=l)


@pytest.mark.parametrize("l_real,lq,want", [
    (4098, 2304, [2304, 1794]), (4098, 1152, [1152, 1152, 1152, 642]),
    (16386, 8448, [8448, 7938]), (300, 128, [128, 128, 44, 0])])
def test_shard_extents(l_real, lq, want):
    assert [shard_extent(l_real, lq, i) for i in range(len(want))] == want
