"""U²-Net salient-object matting — the learned rembg path, in PyTorch.

The port's own copy of open_diffusiongs_tpu/utils/u2net.py (the port
imports nothing of the JAX package).  The reference removes photo
backgrounds with ``rembg.remove`` (pipline_obj.py:256-261), which runs the
U²-Net salient-object detector (Qin et al., Pattern Recognition 2020):
nested RSU (ReSidual U) blocks of dilated conv + BN + ReLU stages around
max-pool / bilinear pyramids.  Here it is an ``nn.Module`` (`U2Net`) of
NCHW ``F.conv2d`` + eval-mode batch norm + ReLU stages: dilated padding,
``max_pool2d(ceil_mode=True)``, bilinear ``align_corners=False``
upsampling, RSU residuals, side-head fusion, seven sigmoid maps.

Weights: the same NPZ layout the JAX module reads
(tools/convert_u2net_weights.py writes it from a torch state dict; kernels
in HWIO), converted to OIHW on load; $U2NET_NPZ names the file
(`default_weights_path`).  `synth_params` draws the same synthetic
weights as the JAX module: it is the fixture of the parity tests.

The convolutions are cuDNN's on the card (JAX leaves them to XLA, not to
Pallas).  They run with TF32 off, so the card agrees with the CPU at the
golden's bar (max 1.5e-3, mean 1e-5): the package turns
``torch.backends.cudnn.allow_tf32`` off at import, and `U2Net.forward`
holds it off for its own call (`_no_tf32`), whatever a caller set.

`u2net_alpha` reproduces how rembg runs the model: LANCZOS resize to
320², divide by the image max, ImageNet normalisation, forward, min-max
of d0, the ``uint8`` truncation, LANCZOS back to the input size.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Architecture spec (JAX utils/u2net.py:40-130)
# ---------------------------------------------------------------------------
#
# A RSU-L(in, mid, out) block is an L-level U-structure: rebnconvin
# (in -> out) at full resolution; encoder rebnconv1..L-1 with 2x2 ceil-mode
# max-pools between them; rebnconv{L} at dilation 2 (no pool); decoder
# rebnconv{L-1}d..1d on concat(up, skip) with bilinear upsampling between
# levels; output = rebnconv1d(..) + rebnconvin(..).  RSU-4F (height 0) has
# no pooling: encoder dilations 1, 2, 4, 8 and decoder dilations 4, 2, 1.


@dataclass(frozen=True)
class RSUSpec:
    name: str      # torch module name, e.g. "stage1"
    height: int    # L; 0 marks the RSU-4F dilated variant
    in_ch: int
    mid_ch: int
    out_ch: int


@dataclass(frozen=True)
class U2NetSpec:
    """Encoder stages 1-6, decoder stages 5d-1d, side-output channels."""
    stages: tuple  # 11 RSUSpec: stage1..stage6, stage5d..stage1d
    out_ch: int = 1

    @property
    def side_channels(self) -> tuple:
        dec = {s.name: s.out_ch for s in self.stages}
        return tuple(dec[n] for n in
                     ("stage1d", "stage2d", "stage3d", "stage4d",
                      "stage5d", "stage6"))


U2NET_FULL = U2NetSpec(stages=(
    RSUSpec("stage1", 7, 3, 32, 64),
    RSUSpec("stage2", 6, 64, 32, 128),
    RSUSpec("stage3", 5, 128, 64, 256),
    RSUSpec("stage4", 4, 256, 128, 512),
    RSUSpec("stage5", 0, 512, 256, 512),
    RSUSpec("stage6", 0, 512, 256, 512),
    RSUSpec("stage5d", 0, 1024, 256, 512),
    RSUSpec("stage4d", 4, 1024, 128, 256),
    RSUSpec("stage3d", 5, 512, 64, 128),
    RSUSpec("stage2d", 6, 256, 32, 64),
    RSUSpec("stage1d", 7, 128, 16, 64),
))

U2NETP = U2NetSpec(stages=(
    RSUSpec("stage1", 7, 3, 16, 64),
    RSUSpec("stage2", 6, 64, 16, 64),
    RSUSpec("stage3", 5, 64, 16, 64),
    RSUSpec("stage4", 4, 64, 16, 64),
    RSUSpec("stage5", 0, 64, 16, 64),
    RSUSpec("stage6", 0, 64, 16, 64),
    RSUSpec("stage5d", 0, 128, 16, 64),
    RSUSpec("stage4d", 4, 128, 16, 64),
    RSUSpec("stage3d", 5, 128, 16, 64),
    RSUSpec("stage2d", 6, 128, 16, 64),
    RSUSpec("stage1d", 7, 128, 16, 64),
))

SPECS = {"u2net": U2NET_FULL, "u2netp": U2NETP}

_BN_EPS = 1e-5


def _rebnconv_names(spec: RSUSpec):
    """REBNCONV sub-module names + (cin, cout, dilation) for one RSU."""
    m, o, h = spec.mid_ch, spec.out_ch, spec.height
    out = [("rebnconvin", spec.in_ch, o, 1)]
    if h == 0:  # RSU-4F
        cin = o
        for i, d in enumerate((1, 2, 4, 8), 1):
            out.append((f"rebnconv{i}", cin, m, d))
            cin = m
        for i, d in zip((3, 2), (4, 2)):
            out.append((f"rebnconv{i}d", 2 * m, m, d))
        out.append(("rebnconv1d", 2 * m, o, 1))
        return out
    cin = o
    for i in range(1, h):
        out.append((f"rebnconv{i}", cin, m, 1))
        cin = m
    out.append((f"rebnconv{h}", m, m, 2))
    for i in range(h - 1, 1, -1):
        out.append((f"rebnconv{i}d", 2 * m, m, 1))
    out.append(("rebnconv1d", 2 * m, o, 1))
    return out


def param_shapes(spec: U2NetSpec) -> dict:
    """NPZ key -> shape for every parameter (kernels in HWIO layout)."""
    shapes = {}

    def conv(path, cin, cout, k):
        shapes[f"{path}.kernel"] = (k, k, cin, cout)
        shapes[f"{path}.bias"] = (cout,)

    def bn(path, c):
        for f in ("scale", "bias", "mean", "var"):
            shapes[f"{path}.{f}"] = (c,)

    for st in spec.stages:
        for name, cin, cout, _ in _rebnconv_names(st):
            conv(f"{st.name}.{name}.conv_s1", cin, cout, 3)
            bn(f"{st.name}.{name}.bn_s1", cout)
    for i, c in enumerate(spec.side_channels, 1):
        conv(f"side{i}", c, spec.out_ch, 3)
    conv("outconv", 6 * spec.out_ch, spec.out_ch, 1)
    return shapes


# ---------------------------------------------------------------------------
# Forward (NCHW)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full f32 for the block, restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    return F.interpolate(src, size=tar.shape[-2:], mode="bilinear",
                         align_corners=False)


class U2Net(nn.Module):
    """The published U2NET.forward graph over a converted NPZ's parameters
    (NPZ key "a.b.kernel" HWIO -> buffer "a__b__kernel" OIHW).  forward:
    x [b, 3, h, w] normalized -> 7 sigmoid maps (d0 fused, d1..d6 side
    outputs), each [b, out_ch, h, w]."""

    def __init__(self, params: dict, spec: U2NetSpec = U2NET_FULL):
        super().__init__()
        self.spec = spec
        for k, v in params.items():
            t = torch.from_numpy(np.asarray(v, np.float32))
            if k.endswith(".kernel"):
                t = t.permute(3, 2, 0, 1)                 # HWIO -> OIHW
            self.register_buffer(k.replace(".", "__"), t.contiguous())

    def _p(self, key: str) -> torch.Tensor:
        return getattr(self, key.replace(".", "__"))

    def _conv(self, path: str, x: torch.Tensor, dilation: int = 1
              ) -> torch.Tensor:
        w = self._p(f"{path}.kernel")
        return F.conv2d(x, w, self._p(f"{path}.bias"),
                        padding=dilation * (w.shape[-1] // 2),
                        dilation=dilation)

    def _rebnconv(self, path: str, x: torch.Tensor, dilation: int
                  ) -> torch.Tensor:
        y = self._conv(f"{path}.conv_s1", x, dilation)
        y = F.batch_norm(y, self._p(f"{path}.bn_s1.mean"),
                         self._p(f"{path}.bn_s1.var"),
                         self._p(f"{path}.bn_s1.scale"),
                         self._p(f"{path}.bn_s1.bias"), training=False,
                         eps=_BN_EPS)
        return F.relu(y)

    def _rsu(self, spec: RSUSpec, x: torch.Tensor) -> torch.Tensor:
        n, h = spec.name, spec.height

        def p(name, y, d):
            return self._rebnconv(f"{n}.{name}", y, d)

        hxin = p("rebnconvin", x, 1)
        if h == 0:  # RSU-4F: constant resolution, dilation pyramid
            hx1 = p("rebnconv1", hxin, 1)
            hx2 = p("rebnconv2", hx1, 2)
            hx3 = p("rebnconv3", hx2, 4)
            hx4 = p("rebnconv4", hx3, 8)
            hx3d = p("rebnconv3d", torch.cat([hx4, hx3], 1), 4)
            hx2d = p("rebnconv2d", torch.cat([hx3d, hx2], 1), 2)
            hx1d = p("rebnconv1d", torch.cat([hx2d, hx1], 1), 1)
            return hx1d + hxin
        enc = []
        hx = hxin
        for i in range(1, h):
            hx = p(f"rebnconv{i}", hx, 1)
            enc.append(hx)
            if i < h - 1:
                hx = _maxpool2_ceil(hx)
        hx = p(f"rebnconv{h}", hx, 2)          # bottom, dilated, no pool
        for i in range(h - 1, 0, -1):
            hx = p(f"rebnconv{i}d", torch.cat([hx, enc[i - 1]], 1), 1)
            if i > 1:
                hx = _upsample_like(hx, enc[i - 2])
        return hx + hxin

    def forward(self, x: torch.Tensor) -> tuple:
        with _no_tf32():
            st = {s.name: s for s in self.spec.stages}
            hx1 = self._rsu(st["stage1"], x)
            hx2 = self._rsu(st["stage2"], _maxpool2_ceil(hx1))
            hx3 = self._rsu(st["stage3"], _maxpool2_ceil(hx2))
            hx4 = self._rsu(st["stage4"], _maxpool2_ceil(hx3))
            hx5 = self._rsu(st["stage5"], _maxpool2_ceil(hx4))
            hx6 = self._rsu(st["stage6"], _maxpool2_ceil(hx5))

            hx5d = self._rsu(st["stage5d"],
                             torch.cat([_upsample_like(hx6, hx5), hx5], 1))
            hx4d = self._rsu(st["stage4d"],
                             torch.cat([_upsample_like(hx5d, hx4), hx4], 1))
            hx3d = self._rsu(st["stage3d"],
                             torch.cat([_upsample_like(hx4d, hx3), hx3], 1))
            hx2d = self._rsu(st["stage2d"],
                             torch.cat([_upsample_like(hx3d, hx2), hx2], 1))
            hx1d = self._rsu(st["stage1d"],
                             torch.cat([_upsample_like(hx2d, hx1), hx1], 1))

            d1 = self._conv("side1", hx1d)
            sides = [d1] + [
                _upsample_like(self._conv(f"side{i}", hx), d1)
                for i, hx in ((2, hx2d), (3, hx3d), (4, hx4d), (5, hx5d),
                              (6, hx6))]
            d0 = self._conv("outconv", torch.cat(sides, 1))
            return tuple(torch.sigmoid(d) for d in [d0] + sides)


def u2net_forward(params: dict, x: torch.Tensor,
                  spec: U2NetSpec = U2NET_FULL) -> tuple:
    """x [b, 3, h, w] normalized (NCHW, on any device) -> the 7 sigmoid
    maps of `U2Net(params, spec)` run on x's device."""
    with torch.no_grad():
        return U2Net(params, spec).to(x.device)(x)


# ---------------------------------------------------------------------------
# Weights IO
# ---------------------------------------------------------------------------


def load_params(path: str, spec: U2NetSpec = U2NET_FULL) -> dict:
    """Load a converted NPZ (tools/convert_u2net_weights.py) and validate
    every expected key / shape (JAX :268-283)."""
    with np.load(path) as z:
        params = {k: np.asarray(z[k], np.float32) for k in z.files}
    want = param_shapes(spec)
    missing = sorted(set(want) - set(params))
    if missing:
        raise ValueError(f"u2net NPZ missing {len(missing)} keys, "
                         f"first: {missing[:4]}")
    for k, s in want.items():
        if tuple(params[k].shape) != tuple(s):
            raise ValueError(f"u2net NPZ key {k}: shape {params[k].shape}"
                             f" != expected {s}")
    return params


def default_weights_path() -> str:
    return os.environ.get(
        "U2NET_NPZ",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "open_diffusiongs_tpu", "u2net.npz"))


_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def u2net_alpha(net, rgb: np.ndarray, *, spec: U2NetSpec = U2NET_FULL,
                size: int = 320, device=None) -> np.ndarray:
    """[h, w, 3] uint8 -> float32 alpha in [0, 1], as rembg computes it
    (JAX :319-340).  `net`: a `U2Net` (run on its own device) or a params
    dict (built with `spec` on `device`: the GPU, raising without one,
    unless it names another)."""
    from PIL import Image

    if not isinstance(net, U2Net):
        from .. import select_device
        net = U2Net(net, spec).to(select_device(device))
    dev = next(iter(net.buffers())).device
    h0, w0 = rgb.shape[:2]
    im = Image.fromarray(rgb).convert("RGB").resize((size, size),
                                                    Image.LANCZOS)
    x = np.asarray(im, np.float32)
    x = x / max(float(x.max()), 1e-6)
    x = (x - _IMAGENET_MEAN) / _IMAGENET_STD
    with torch.no_grad():
        d0 = net(torch.from_numpy(
            np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(dev))[0]
    d0 = d0[0, 0].cpu().numpy()
    d0 = (d0 - d0.min()) / max(float(d0.max() - d0.min()), 1e-8)
    out = Image.fromarray((d0 * 255).astype(np.uint8)).resize(
        (w0, h0), Image.LANCZOS)
    return np.asarray(out, np.float32) / 255.0


def synth_params(spec: U2NetSpec, seed: int = 2025) -> dict:
    """Deterministic synthetic parameters in the NPZ layout (He-init
    kernels, randomized BN stats), drawn exactly as the JAX module draws
    them."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in param_shapes(spec).items():
        if k.endswith(".kernel"):
            kh, kw, cin, _ = shape
            out[k] = rng.normal(
                0, np.sqrt(2.0 / (kh * kw * cin)), shape).astype(np.float32)
        elif k.endswith(".scale") or k.endswith(".var"):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:  # conv bias / bn bias / bn mean
            out[k] = rng.normal(0, 0.1, shape).astype(np.float32)
    return out
