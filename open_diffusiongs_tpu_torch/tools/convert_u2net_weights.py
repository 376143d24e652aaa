"""Convert a U²-Net torch checkpoint (rembg's u2net.pth / u2netp.pth) to
the NPZ that utils/u2net.py::load_params reads, without the JAX package.

  python -m open_diffusiongs_tpu_torch.tools.convert_u2net_weights \\
      --ckpt u2net.pth --out u2net.npz [--spec u2net|u2netp]

The checkpoint is read with `torch.load(weights_only=True)`.  The NPZ is
the one tools/convert_u2net_weights.py::convert_state_dict writes
(`convert_state_dict` here is its copy): the torch module paths, kernels
in HWIO ([kh, kw, cin, cout]), BatchNorm's weight / bias / running_mean /
running_var renamed scale / bias / mean / var, num_batches_tracked
dropped.  The result is held against `utils/u2net.py::param_shapes` of
the spec: a missing, extra or misshapen array raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.u2net import SPECS, param_shapes

_BN_RENAME = {"weight": "scale", "bias": "bias",
              "running_mean": "mean", "running_var": "var"}


def _f32(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_state_dict(sd: dict) -> dict:
    """Map a torch-naming state dict (numpy or tensor values) to the NPZ
    layout.  num_batches_tracked is dropped; an unknown field raises."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        v = _f32(v)
        mod, field = ".".join(parts[:-1]), parts[-1]
        if ".bn_s1" in k:
            out[f"{mod}.{_BN_RENAME[field]}"] = v
        elif field == "weight":            # conv kernels (conv_s1/side/out)
            if v.ndim != 4:
                raise ValueError(f"unexpected weight rank for {k}: {v.ndim}")
            out[f"{mod + '.kernel' if mod else 'kernel'}"] = \
                np.transpose(v, (2, 3, 1, 0))
        elif field == "bias":
            out[f"{mod}.bias" if mod else "bias"] = v
        else:
            raise ValueError(f"unrecognized u2net state-dict key: {k}")
    return out


def check_layout(params: dict, spec: str) -> None:
    """Raise unless `params` holds exactly the keys and shapes of
    `param_shapes(SPECS[spec])`."""
    want = param_shapes(SPECS[spec])
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise ValueError(f"{spec} layout mismatch: missing {missing[:4]} "
                         f"({len(missing)}), extra {extra[:4]} "
                         f"({len(extra)})")
    for k, s in want.items():
        if tuple(params[k].shape) != tuple(s):
            raise ValueError(f"{k}: shape {params[k].shape} != {s}")


def convert_file(path: str, spec: str = "u2net") -> dict:
    """The checked NPZ arrays of the checkpoint at `path`."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict ({type(sd).__name__})")
    params = convert_state_dict(sd)
    check_layout(params, spec)
    return params


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--spec", default="u2net", choices=sorted(SPECS))
    args = p.parse_args(argv)
    params = convert_file(args.ckpt, args.spec)
    np.savez_compressed(args.out, **params)
    print(f"wrote {args.out}: {len(params)} arrays")


if __name__ == "__main__":
    main()
