"""Convert the LPIPS-VGG16 weights to the NPZ that
systems/losses.py::lpips_init_params reads, without the `lpips` package.

  python -m open_diffusiongs_tpu_torch.tools.convert_lpips_weights \\
      --vgg16 vgg16-397923af.pth --lin vgg.pth --out lpips_vgg.npz

`lpips.LPIPS(net="vgg")` loads two files, and this tool reads the same
two with `torch.load(weights_only=True)`:
  * torchvision's VGG16 state dict (`vgg16-397923af.pth`), of which the
    13 convolutions `features.{0,2,5,7,10,12,14,17,19,21,24,26,28}.weight`
    ([cout, cin, 3, 3]) and `.bias` are the backbone;
  * the lpips package's linear heads (`weights/v0.1/vgg.pth`),
    `lin{0..4}.model.1.weight` ([1, c, 1, 1]).

The NPZ is the one tools/convert_lpips_weights.py::convert_arrays writes
(`convert_arrays` here is its copy): `vgg/{stage}_{conv}/kernel` in HWIO
and `/bias`, `lin/{stage}/kernel` squeezed to [c] and clamped at 0.
"""

from __future__ import annotations

import argparse

import numpy as np

# torchvision.models.vgg16().features indices of each stage's convolutions
STAGE_CONV_IDXS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
# (out_channels, n_convs) per stage, as systems/losses.py::VGG_STAGES
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def convert_arrays(conv_weights, conv_biases, lin_weights) -> dict:
    """Map torch-layout LPIPS arrays to the NPZ layout.

    conv_weights / conv_biases: per stage, a list of conv arrays in torch
    layout ([cout, cin, kh, kw] / [cout]); lin_weights: per stage, the
    NetLinLayer 1x1 conv weight ([1, cin, 1, 1])."""
    out = {}
    for si, (ws, bs) in enumerate(zip(conv_weights, conv_biases)):
        for ci, (w, b) in enumerate(zip(ws, bs)):
            out[f"vgg/{si}_{ci}/kernel"] = np.transpose(
                np.asarray(w), (2, 3, 1, 0))
            out[f"vgg/{si}_{ci}/bias"] = np.asarray(b)
    for si, w in enumerate(lin_weights):
        # shipped lpips checkpoints keep the heads non-negative (the paper
        # clamps during training); clamp on conversion, as the root tool
        out[f"lin/{si}/kernel"] = np.maximum(
            np.asarray(w)[0, :, 0, 0], 0.0)
    return out


def npz_shapes() -> dict:
    """NPZ key -> shape of every array lpips_init_params reads."""
    shapes, cin = {}, 3
    for si, (cout, n_convs) in enumerate(VGG_STAGES):
        for ci in range(n_convs):
            shapes[f"vgg/{si}_{ci}/kernel"] = (3, 3, cin, cout)
            shapes[f"vgg/{si}_{ci}/bias"] = (cout,)
            cin = cout
        shapes[f"lin/{si}/kernel"] = (cout,)
    return shapes


def _load(path: str) -> dict:
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict ({type(sd).__name__})")
    return sd


def _array(sd: dict, key: str, path: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"{path}: no {key!r}")
    return sd[key].detach().cpu().numpy()


def convert_files(vgg16_path: str, lin_path: str) -> dict:
    """The NPZ arrays of torchvision's VGG16 state dict and the lpips
    heads' state dict; raises on a missing key or a misshapen array."""
    vgg, lin = _load(vgg16_path), _load(lin_path)
    conv_w = [[_array(vgg, f"features.{i}.weight", vgg16_path)
               for i in idxs] for idxs in STAGE_CONV_IDXS]
    conv_b = [[_array(vgg, f"features.{i}.bias", vgg16_path)
               for i in idxs] for idxs in STAGE_CONV_IDXS]
    lin_w = [_array(lin, f"lin{si}.model.1.weight", lin_path)
             for si in range(len(STAGE_CONV_IDXS))]
    out = convert_arrays(conv_w, conv_b, lin_w)
    for key, shape in npz_shapes().items():
        if out[key].shape != shape:
            raise ValueError(f"{key}: shape {out[key].shape} != {shape}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--vgg16", required=True,
                   help="torchvision's VGG16 state dict (.pth)")
    p.add_argument("--lin", required=True,
                   help="the lpips package's weights/v0.1/vgg.pth")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = convert_files(args.vgg16, args.lin)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({len(out)} arrays)")


if __name__ == "__main__":
    main()
