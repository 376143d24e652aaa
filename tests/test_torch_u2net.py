"""U²-Net matting: the port's utils/u2net.py against the recorded reference
execution (tests/golden/reference_u2net.npz, tools/make_u2net_golden.py)
and the JAX package's module (open_diffusiongs_tpu/utils/u2net.py).

* the forward at all three golden entries under the golden's bars
  (tests/test_u2net_golden.py:85-104: max 1.5e-3, mean 1e-5);
* `load_params` of a `synth_params` NPZ round trip, with the JAX module's
  draws;
* `u2net_alpha` against JAX's for u2netp on a 70 x 90 image at size 96:
  max abs <= 2/255 (both truncate d0 * 255 to uint8, and a d0 within
  f32 rounding of a step truncates one step apart, which the LANCZOS
  resize back may spread to a neighbour; on this case they are equal);
* `remove_background("u2net")` reads $U2NET_NPZ, and raises without it.
"""

import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.utils import u2net as ju2net
from open_diffusiongs_tpu_torch import pipeline
from open_diffusiongs_tpu_torch.utils import u2net

GOLDEN = "tests/golden/reference_u2net.npz"


@pytest.fixture(scope="module")
def golden(request):
    return np.load(request.config.rootpath / GOLDEN)


@pytest.mark.parametrize("spec_name,size", [
    ("u2netp", 160), ("u2netp", 88), ("u2net", 64)])
def test_forward_matches_reference_execution(golden, spec_name, size):
    spec = u2net.SPECS[spec_name]
    params = u2net.synth_params(spec, seed=2025)
    x = torch.from_numpy(golden[f"{spec_name}_{size}/x"])   # NCHW
    ds = u2net.u2net_forward(params, x, spec)
    assert len(ds) == 7
    for i, d in enumerate(ds):
        want = golden[f"{spec_name}_{size}/d{i}"]
        assert d.shape == want.shape
        err = np.abs(d.numpy() - want)
        assert float(err.max()) < 1.5e-3, (i, float(err.max()))
        assert float(err.mean()) < 1e-5, (i, float(err.mean()))


def test_synth_params_and_load_params_round_trip(tmp_path):
    params = u2net.synth_params(u2net.U2NETP, seed=1)
    want = ju2net.synth_params(ju2net.U2NETP, seed=1)
    assert set(params) == set(want) == set(u2net.param_shapes(u2net.U2NETP))
    for k in want:
        np.testing.assert_array_equal(params[k], want[k], err_msg=k)
    path = str(tmp_path / "u2netp.npz")
    np.savez(path, **params)
    loaded = u2net.load_params(path, u2net.U2NETP)
    for k in params:
        np.testing.assert_array_equal(loaded[k], params[k], err_msg=k)
    net = u2net.U2Net(loaded, u2net.U2NETP)
    w = loaded["stage1.rebnconvin.conv_s1.kernel"]          # HWIO
    np.testing.assert_array_equal(
        net.stage1__rebnconvin__conv_s1__kernel.numpy(),
        w.transpose(3, 2, 0, 1))                            # OIHW
    bad = dict(params)
    bad.pop("outconv.kernel")
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="missing"):
        u2net.load_params(str(tmp_path / "bad.npz"), u2net.U2NETP)


def test_u2net_alpha_matches_jax():
    params = u2net.synth_params(u2net.U2NETP, seed=2025)
    rgb = np.random.default_rng(3).integers(0, 255, (70, 90, 3),
                                            dtype=np.uint8)
    got = u2net.u2net_alpha(u2net.U2Net(params, u2net.U2NETP), rgb,
                            size=96)
    want = ju2net.u2net_alpha(params, rgb, spec=ju2net.U2NETP, size=96)
    assert got.shape == (70, 90) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 2 / 255 + 1e-7
    assert float(np.ptp(got)) > 0.5
    # a params dict is built on the named device
    np.testing.assert_array_equal(
        u2net.u2net_alpha(params, rgb, spec=u2net.U2NETP, size=96,
                          device="cpu"), got)


def test_remove_background_u2net_reads_the_npz(tmp_path, monkeypatch):
    rgb = np.random.default_rng(4).integers(0, 255, (40, 30, 3),
                                            dtype=np.uint8)
    monkeypatch.setattr(pipeline, "_U2NET_CACHE", {})
    monkeypatch.setenv("U2NET_NPZ", str(tmp_path / "none.npz"))
    with pytest.raises(RuntimeError, match="no converted weights NPZ"):
        pipeline.remove_background(rgb, "u2net", device="cpu")

    params = u2net.synth_params(u2net.U2NETP, seed=2025)
    path = str(tmp_path / "u2netp.npz")
    np.savez(path, **params)
    monkeypatch.setenv("U2NET_NPZ", path)
    monkeypatch.setenv("U2NET_SPEC", "u2netp")
    alpha = pipeline.remove_background(rgb, "u2net", device="cpu")
    np.testing.assert_array_equal(alpha, u2net.u2net_alpha(
        u2net.U2Net(params, u2net.U2NETP), rgb))
    assert alpha.shape == (40, 30)
