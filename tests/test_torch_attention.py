"""PyTorch port vs the JAX package: packed-layout attention.

`flash_mha_packed_ref` (the plain twin of the CUDA kernel, which is what
`flash_mha_packed` runs for CPU tensors) against the JAX Pallas kernel
`flash_mha_packed` in interpret mode, on the same numpy inputs in f32.
Bars: atol 2e-4 / rtol 1e-3, the f32 attention bar of
tests/test_attention.py (exp2-domain softmax, summed in another order).
The CUDA kernel itself is held against the plain version on the GPU by
chip_smoke.py (phase 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops.attention import flash_mha_packed as jax_packed
from open_diffusiongs_tpu_torch.ops import attention

TOL = dict(atol=2e-4, rtol=1e-3)


def _inputs(rng, b, l, lp, hd, pad_fill=None):
    real = rng.normal(size=(3, b, l, hd)).astype(np.float32)
    if pad_fill is None:
        pad = rng.normal(size=(3, b, lp - l, hd)).astype(np.float32)
    else:
        pad = np.full((3, b, lp - l, hd), pad_fill, np.float32)
    return np.concatenate([real, pad], axis=2)          # [3, b, lp, hd]


@pytest.mark.parametrize("h,dh", [(4, 32), (2, 64), (8, 16)])
def test_ref_matches_jax_packed_kernel(h, dh):
    rng = np.random.default_rng(dh)
    l, lp = 300, 512
    q, k, v = _inputs(rng, 1, l, lp, h * dh)
    ref = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     num_heads=h, l_real=l, blocks=(128, 128),
                     interpret=True)
    ours = attention.flash_mha_packed_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        num_heads=h, l_real=l)
    assert ours.shape == (1, lp, h * dh) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours[:, :l].numpy(),
                               np.asarray(ref)[:, :l], **TOL)


def test_huge_pad_garbage_does_not_leak():
    """Pad rows holding 1e4 (the DiT's pad rows carry arbitrary layer
    outputs) must not move the real rows: against plain XLA attention over
    the real rows only."""
    rng = np.random.default_rng(3)
    b, l, lp, h, dh = 1, 300, 512, 2, 64
    q, k, v = _inputs(rng, b, l, lp, h * dh, pad_fill=1e4)
    ref = jax.nn.dot_product_attention(
        *(jnp.asarray(x[:, :l]).reshape(b, l, h, dh) for x in (q, k, v)))
    ours = attention.flash_mha_packed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        num_heads=h, l_real=l)
    out = ours[:, :l].numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref).reshape(b, l, h * dh),
                               **TOL)


def test_cpu_wrapper_is_the_plain_version_and_never_launches():
    """On CPU tensors the wrapper IS the plain version (bit-identical) and
    the launch counter stays at 0; bf16 inputs come back bf16."""
    rng = np.random.default_rng(1)
    before = attention.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(rng, 2, 70, 96, 64))
        out = attention.flash_mha_packed(q, k, v, num_heads=2, l_real=70)
        ref = attention.flash_mha_packed_ref(q, k, v, num_heads=2, l_real=70)
        assert out.dtype == dtype
        assert torch.equal(out, ref)
    assert attention.LAUNCHES == before == 0


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        attention.flash_mha_packed(x, x, x, num_heads=3, l_real=8)
    with pytest.raises(ValueError):
        attention.flash_mha_packed(x, x, x, num_heads=2, l_real=9)
    with pytest.raises(ValueError):
        attention.flash_mha_packed(x, x[:, :4], x, num_heads=2, l_real=4)
