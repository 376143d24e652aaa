"""PyTorch port vs the JAX package: the general attention route and the two
attention variants.

  * `flash_full_mha_ref` (the plain twin of csrc/flash_full_fwd.cu, what
    `flash_full_mha` runs for CPU tensors) against the JAX Pallas
    `flash_full_mha` in interpret mode, f32, on the cases of
    tests/test_attention.py:26-56 plus head widths 48, 40 and 20.  Bar:
    atol 2e-4 / rtol 1e-3, the f32 attention bar;
  * #5's q pre-scale in bf16: scale and product both rounded to bf16, bit
    for bit as JAX forms them (the packed path rounds once, in f32);
  * the scalar-max twin against JAX `flash_mha_packed(scalar_max=True)` in
    interpret mode on tests/test_attention.py:230-262's cases: with
    block_rows = the JAX call's bq it is the TPU kernel's function (atol
    2e-4 / rtol 1e-3); with block_rows = 64, the CUDA kernel's q tile, it
    holds the JAX test's bar 2e-2; and against the row-max twin (2e-4);
  * `mha_full_ref` (all four pv_f32 x score_bf16 pairs) against
    tools/bench_attn2.py::mha_full in interpret mode, bf16: within two bf16
    ulps of the output's magnitude (4e-3) with f32 scores, and within the
    tool's own --check bar 2e-2 with bf16 scores.
The kernels are held against these twins on the GPU by chip_smoke.py
(phase 9).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops.attention import flash_full_mha as jax_full
from open_diffusiongs_tpu.ops.attention import flash_mha_packed as jax_packed
from open_diffusiongs_tpu_torch.ops import attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)
LOG2E = 1.4426950408889634


# (b, l, h, d, blocks, sigma of q/k, seed)
FULL_CASES = {
    "padded_700_h3": (2, 700, 3, 64, (512, 512), 1.0, 0),
    "single_block_100": (1, 100, 2, 64, (512, 512), 1.0, 0),
    "asymmetric_1100": (1, 1100, 2, 64, (1024, 512), 1.0, 0),
    "large_logits_sigma12": (1, 600, 2, 64, (512, 512), 12.0, 1),
    "d48": (1, 300, 2, 48, (128, 128), 1.0, 2),
    "d40": (1, 300, 3, 40, (128, 128), 1.0, 3),
    "d20": (2, 150, 3, 20, (128, 128), 1.0, 4),
}


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_ref_matches_jax_kernel(case):
    b, l, h, d, blocks, sigma, seed = FULL_CASES[case]
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(0, sigma, (b, l, h, d)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, l, h, d)).astype(np.float32)
    ref = np.asarray(jax_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              blocks=blocks, interpret=True))
    ours = attention.flash_full_mha_ref(*map(torch.from_numpy, (q, k, v)))
    assert ours.shape == (b, l, h, d) and ours.dtype == torch.float32
    assert torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)


@pytest.mark.parametrize("d", [64, 48, 20])
def test_full_prescale_is_jax_bf16_bit_for_bit(d):
    """#5 forms the scale and q * scale in q's dtype (JAX :652-654): in bf16
    the scale itself is rounded (0.18066 for 0.18034 at d = 64).  The
    helper equals JAX bit for bit, and it is not the packed path's
    single-rounding `_prescaled_q`."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(2, 97, 3, d)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray((jq * jnp.asarray(d ** -0.5 * LOG2E, jnp.bfloat16))
                      .astype(jnp.float32))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = attention._full_prescaled_q(tq)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    scale = attention._full_scale(d, torch.bfloat16)
    assert scale == float(jnp.asarray(d ** -0.5 * LOG2E, jnp.bfloat16))
    assert scale != d ** -0.5 * LOG2E
    packed = attention._prescaled_q(tq, d)
    assert not torch.equal(got, packed)


def test_full_wrapper_on_cpu_is_the_twin_and_never_launches():
    rng = np.random.default_rng(5)
    before = attention.LAUNCHES_FULL
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 20, 7):
            q, k, v = (torch.from_numpy(rng.normal(size=(2, 33, 3, d))
                                        .astype(np.float32)).to(dtype)
                       for _ in range(3))
            out = attention.flash_full_mha(q, k, v)
            assert out.dtype == dtype and out.shape == q.shape
            assert torch.equal(out, attention.flash_full_mha_ref(q, k, v))
    assert attention.LAUNCHES_FULL == before == 0
    x = torch.zeros(1, 8, 2, 80)
    with pytest.raises(ValueError, match="<= 64"):
        attention.flash_full_mha(x, x, x)
    with pytest.raises(ValueError):
        attention.flash_full_mha(x[..., :64], x[:, :4, :, :64], x[..., :64])


def _packed_inputs(b, l, lp, h, dh, seed, sigma=1.0, pad=None):
    """q, k, v [b, Lp, h*dh] f32: real rows N(0, sigma) (v N(0, 1)), pad
    rows N(0, 1) garbage, or `pad` (a fill value)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, b, lp, h * dh)).astype(np.float32)
    x[:2, :, :l] *= sigma
    if pad is not None:
        x[:, :, l:] = pad
    return x


# (b, l, lp, h, dh, blocks, sigma, pad fill); test_attention.py:230-262
SMAX_CASES = {
    "padded_700": (2, 700, 1024, 4, 64, (512, 512), 1.0, None),
    "asymmetric_1400": (1, 1400, 1536, 2, 64, (1536, 512), 1.0, None),
    "large_scores_sigma2.5": (1, 600, 1024, 2, 64, (512, 512), 2.5, 0.0),
}


@pytest.mark.parametrize("case", list(SMAX_CASES))
def test_scalar_max_twin_matches_jax_kernel(case):
    b, l, lp, h, dh, blocks, sigma, pad = SMAX_CASES[case]
    q, k, v = _packed_inputs(b, l, lp, h, dh, seed=3, sigma=sigma, pad=pad)
    ref = np.asarray(jax_packed(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), num_heads=h, l_real=l,
                                blocks=blocks, scalar_max=True,
                                interpret=True))[:, :l]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(num_heads=h, l_real=l, scalar_max=True)
    same = attention.flash_mha_packed_ref(tq, tk, tv, block_rows=blocks[0],
                                          **kw)[:, :l].numpy()
    np.testing.assert_allclose(same, ref, **TOL)
    cuda_tile = attention.flash_mha_packed_ref(tq, tk, tv, block_rows=64,
                                               **kw)[:, :l].numpy()
    assert np.isfinite(cuda_tile).all()
    assert np.abs(cuda_tile - ref).max() < 2e-2


def test_scalar_max_twin_matches_row_max_twin():
    q, k, v = map(torch.from_numpy,
                  _packed_inputs(2, 300, 384, 4, 32, seed=6))
    kw = dict(num_heads=4, l_real=300)
    smax = attention.flash_mha_packed_ref(q, k, v, scalar_max=True, **kw)
    row = attention.flash_mha_packed_ref(q, k, v, **kw)
    np.testing.assert_allclose(smax[:, :300].numpy(), row[:, :300].numpy(),
                               atol=2e-4, rtol=0)


def test_scalar_max_underflow_is_part_of_the_function():
    """The shared max includes the block's pad q rows (< Lp): 1e4 garbage
    there underflows the block's real rows to exactly 0 (denominator
    clamped at 1e-30), in the twin as in the TPU kernel; other blocks and
    the row-max kernel are unaffected.  The pad keys' score 0 also counts,
    and rows past Lp do not."""
    b, l, lp, h, dh = 1, 100, 160, 2, 32
    q, k, v = map(torch.from_numpy,
                  _packed_inputs(b, l, lp, h, dh, seed=7, pad=1e4))
    kw = dict(num_heads=h, l_real=l, scalar_max=True, block_rows=64)
    o = attention.flash_mha_packed_ref(q, k, v, **kw)
    row = attention.flash_mha_packed_ref(q, k, v, num_heads=h, l_real=l)
    assert torch.isfinite(o[:, :l]).all()
    assert not o[:, 64:l].any()                   # block 1 holds pad rows
    np.testing.assert_allclose(o[:, :64].numpy(), row[:, :64].numpy(),
                               atol=2e-4, rtol=0)
    assert row[:, 64:l].any()
    # the max: blocks of 64 rows over Lp = 160 (the last one 32 rows), and
    # the pad keys' 0 lifts an all-negative block max
    s = -torch.rand(1, 1, 160, 5) - 1.0
    m = attention._block_max(s, 64, pad_keys=True)
    assert m.shape == (1, 1, 160, 1) and torch.all(m == 0)
    m = attention._block_max(s, 64, pad_keys=False)
    for lo, hi in ((0, 64), (64, 128), (128, 160)):
        assert torch.all(m[..., lo:hi, 0] == s[..., lo:hi, :].max())


def test_scalar_max_wrapper_on_cpu_and_its_limits():
    q, k, v = map(torch.from_numpy, _packed_inputs(1, 90, 128, 2, 64, seed=8))
    kw = dict(num_heads=2, l_real=90)
    before = attention.LAUNCHES_SMAX
    out = attention.flash_mha_packed(q, k, v, scalar_max=True, **kw)
    assert torch.equal(out, attention.flash_mha_packed_ref(
        q, k, v, scalar_max=True, block_rows=attention.SMAX_BLOCK_ROWS, **kw))
    assert attention.LAUNCHES_SMAX == before == 0
    with pytest.raises(ValueError, match="stats"):
        attention.flash_mha_packed(q, k, v, scalar_max=True, with_stats=True,
                                   **kw)


@pytest.mark.parametrize("dh", [8, 4, 48])
def test_packed_kernels_name_their_head_width_limit(dh):
    """dh 16, 32 and 64 launch; any other packed width raises naming the
    limit (checked before the device, so the CPU sees it)."""
    x = torch.zeros(1, 8, 2 * dh)
    with pytest.raises(ValueError, match="16, 32 or 64"):
        attention._check_cuda("flash_mha_packed", x, dh, dict(q=x))


@pytest.fixture(scope="module")
def bench_attn2():
    """tools/bench_attn2.py, imported with the JAX compile cache left off
    (the tool points it at a directory outside the repo at import time)."""
    import open_diffusiongs_tpu.utils.cache as cache
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cache, "enable_persistent_cache", lambda *a, **k: None)
        spec = importlib.util.spec_from_file_location(
            "_bench_attn2_under_test",
            os.path.join(ROOT, "tools", "bench_attn2.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pv_f32", [False, True])
@pytest.mark.parametrize("score_bf16", [False, True])
def test_mha_full_ref_matches_bench_kernel(bench_attn2, pv_f32, score_bf16):
    """bench_attn2's --check case, small: 2 heads, 700 real rows padded to
    1024 with zeros, blocks of 512, q pre-scaled as the tool expects."""
    h, lp, l, d = 2, 1024, 700, 64
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, h, lp, d)).astype(np.float32)
    x[:, :, l:] = 0
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in x)
    qs = q * (d ** -0.5 * LOG2E)
    ref = np.asarray(bench_attn2.mha_full(
        qs, k, v, bq=512, bkv=512, l_real=l, pv_f32=pv_f32,
        score_bf16=score_bf16, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (qs, k, v))
    ours = attention.mha_full(tq, tk, tv, l_real=l, pv_f32=pv_f32,
                              score_bf16=score_bf16)
    assert ours.dtype == torch.bfloat16 and ours.shape == (h, lp, d)
    err = np.abs(ours.float().numpy() - ref).max()
    assert err < (2e-2 if score_bf16 else 4e-3), err


def test_bench_tool_check_runs_on_cpu_twins(capsys):
    """The bench entry point's check plumbing (layouts, the fused qkv of the
    scalar-max row, error reduction) on CPU tensors, where every wrapper is
    its twin: all errors 0.  Its --help says the TPU block specs do not
    apply."""
    from open_diffusiongs_tpu_torch.tools import bench_attn
    res = bench_attn.check(torch.device("cpu"), heads=2)
    assert set(res) == set(bench_attn.VARIANTS) | {bench_attn.SMAX}
    assert all(r["max_abs_err"] == 0.0 for r in res.values()), res
    with pytest.raises(SystemExit):
        bench_attn.main(["--help"])
    assert "ATTN_BLOCKS" in capsys.readouterr().out
