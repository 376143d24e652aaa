"""Weight bridge: a flax DGSDenoiser param tree -> the port's state_dict.

The inverse of tools/convert_reference_ckpt.py::convert_state_dict
(:82-117).  The port's module names are the reference's own, so a
reference checkpoint loads with `load_state_dict` directly; params of the
JAX package reach the port through this bridge:
  * flax Dense kernels are [in, out]; torch Linear weights [out, in]:
    every kernel is transposed;
  * the JAX Attention keeps q, k and v as three Denses
    (transformer.py:364-366); the reference fuses them into one qkv
    Linear whose output rows are q | k | v;
  * the JAX stack is one nn.scan whose params carry a leading layer axis
    (`transformer/layers/block/*`, transformer.py:598-607); the port has
    one module per layer (`transformer.{i}.*`);
  * a qk_norm block's per-head RMSNorm scales `attn/{q,k}_norm/weight`
    (transformer.py:395-397) become `attn.{q,k}_norm.weight`.
Inputs are NumPy arrays (pass a flax tree through `jax.device_get`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# torch name -> (flax path, transpose)
_STATIC_MAP = {
    "t_embedder.mlp.0.weight": ("t_embedder/mlp_0/kernel", True),
    "t_embedder.mlp.0.bias": ("t_embedder/mlp_0/bias", False),
    "t_embedder.mlp.2.weight": ("t_embedder/mlp_2/kernel", True),
    "t_embedder.mlp.2.bias": ("t_embedder/mlp_2/bias", False),
    "image_tokenizer.1.weight": ("image_tokenizer/kernel", True),
    "gaussians_pos_embedding": ("gaussians_pos_embedding", False),
    "transformer_input_layernorm.weight":
        ("transformer_input_layernorm/scale", False),
}
for _head in ("upsampler", "image_token_decoder"):
    _STATIC_MAP.update({
        f"{_head}.layernorm.weight": (f"{_head}/layernorm/scale", False),
        f"{_head}.linear.weight": (f"{_head}/linear/kernel", True),
        f"{_head}.adaLN_modulation.1.weight":
            (f"{_head}/adaLN_modulation_1/kernel", True),
        f"{_head}.adaLN_modulation.1.bias":
            (f"{_head}/adaLN_modulation_1/bias", False),
    })

_LAYER_PREFIX = "transformer/layers/block/"
# per-layer torch sub-name -> (flax sub-path, transpose)
_LAYER_MAP = {
    "attn.proj.weight": ("attn/proj/kernel", True),
    "attn.proj.bias": ("attn/proj/bias", False),
    "mlp.fc1.weight": ("mlp/fc1/kernel", True),
    "mlp.fc1.bias": ("mlp/fc1/bias", False),
    "mlp.fc2.weight": ("mlp/fc2/kernel", True),
    "mlp.fc2.bias": ("mlp/fc2/bias", False),
    "adaLN_modulation.1.weight": ("adaLN_modulation_1/kernel", True),
    "adaLN_modulation.1.bias": ("adaLN_modulation_1/bias", False),
}
# present only in qk_norm blocks
_QK_NORM_MAP = {"attn.q_norm.weight": "attn/q_norm/weight",
                "attn.k_norm.weight": "attn/k_norm/weight"}


def flatten_params(tree: Dict[str, Any], prefix: str = ""
                   ) -> Dict[str, np.ndarray]:
    """Nested flax dict -> {'a/b/c': array}, dropping a top 'params' level."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if not prefix and k == "params":
            out.update(flatten_params(v))
            continue
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_params(dict(v), path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def state_dict_from_flax(params: Dict[str, Any],
                         ray_pe_type: str = "relative_plk"
                         ) -> Dict[str, torch.Tensor]:
    """flax DGSDenoiser params (NumPy leaves) -> the port's state_dict (f32
    tensors).  The scene variant ("plk") stores the free-Gaussian
    embedding as [1, n, width], like the reference."""
    return state_dict_from_flat(flatten_params(params), ray_pe_type)


def state_dict_from_flat(flat: Dict[str, np.ndarray],
                         ray_pe_type: str = "relative_plk"
                         ) -> Dict[str, torch.Tensor]:
    """'/'-joined flax paths -> the port's state_dict (f32 tensors): the
    NPZ of tools/convert_reference_ckpt.py read back, or a flattened flax
    tree.  The NPZ keeps the free-Gaussian embedding as [n, width] for
    both variants (convert_state_dict :90-91); "plk" restores [1, n,
    width]."""
    sd: Dict[str, np.ndarray] = {}
    for name, (path, transpose) in _STATIC_MAP.items():
        w = np.asarray(flat[path], np.float32)
        sd[name] = w.T if transpose else w
    if ray_pe_type == "plk":
        sd["gaussians_pos_embedding"] = sd["gaussians_pos_embedding"][None]
    n_layers = flat[_LAYER_PREFIX + "attn/q/kernel"].shape[0]
    for i in range(n_layers):
        block = {sub[len(_LAYER_PREFIX):]: np.asarray(w[i], np.float32)
                 for sub, w in flat.items() if sub.startswith(_LAYER_PREFIX)}
        sd.update({f"transformer.{i}.{name}": w
                   for name, w in _block_state(block).items()})
    return {k: torch.tensor(v, dtype=torch.float32)
            for k, v in sd.items()}


def _block_state(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One DiTBlock's flat flax params (`attn/q/kernel`, ...) -> the
    port's block state-dict entries (`attn.qkv.weight`, ...)."""
    sd = {"attn.qkv.weight": np.concatenate(
              [flat[f"attn/{p}/kernel"].T for p in "qkv"], axis=0),
          "attn.qkv.bias": np.concatenate(
              [flat[f"attn/{p}/bias"] for p in "qkv"], axis=0)}
    for name, (sub, transpose) in _LAYER_MAP.items():
        sd[name] = flat[sub].T if transpose else flat[sub]
    sd.update({name: flat[sub] for name, sub in _QK_NORM_MAP.items()
               if sub in flat})
    return sd


def block_state_dict_from_flax(params: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """flax DiTBlock params (NumPy leaves) -> the port's DiTBlock
    state_dict (f32 tensors), q/k norms included when present."""
    return {k: torch.tensor(v, dtype=torch.float32)
            for k, v in _block_state(flatten_params(params)).items()}
