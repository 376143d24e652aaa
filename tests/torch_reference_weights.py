"""A synthetic DGSDenoiser state dict in the reference's own names (the
layout of tests/test_pretrained_flow.py:58-86), for the port's weight
loading tests."""

import numpy as np
import torch


def reference_state_dict(rng, d: int = 64, layers: int = 2, p: int = 8,
                         n_gaussians: int = 2) -> dict:
    """{reference name: f32 array}: Linear weights [out, in] and biases
    ~ N(0, 0.02), LayerNorm scales 1, fused qkv rows q | k | v."""
    def t(shape):
        return rng.normal(0, 0.02, size=shape).astype(np.float32)

    ones = np.ones((d,), np.float32)
    sd = {
        "t_embedder.mlp.0.weight": t((d, 256)),
        "t_embedder.mlp.0.bias": t((d,)),
        "t_embedder.mlp.2.weight": t((d, d)),
        "t_embedder.mlp.2.bias": t((d,)),
        "image_tokenizer.1.weight": t((d, 9 * p * p)),
        "gaussians_pos_embedding": t((n_gaussians, d)),
        "transformer_input_layernorm.weight": ones,
        "upsampler.layernorm.weight": ones,
        "upsampler.linear.weight": t((14, d)),
        "upsampler.adaLN_modulation.1.weight": t((2 * d, d)),
        "upsampler.adaLN_modulation.1.bias": t((2 * d,)),
        "image_token_decoder.layernorm.weight": ones,
        "image_token_decoder.linear.weight": t((p * p * 14, d)),
        "image_token_decoder.adaLN_modulation.1.weight": t((2 * d, d)),
        "image_token_decoder.adaLN_modulation.1.bias": t((2 * d,)),
    }
    for i in range(layers):
        for k, shape in [("attn.qkv.weight", (3 * d, d)),
                         ("attn.qkv.bias", (3 * d,)),
                         ("attn.proj.weight", (d, d)),
                         ("attn.proj.bias", (d,)),
                         ("mlp.fc1.weight", (4 * d, d)),
                         ("mlp.fc1.bias", (4 * d,)),
                         ("mlp.fc2.weight", (d, 4 * d)),
                         ("mlp.fc2.bias", (d,)),
                         ("adaLN_modulation.1.weight", (6 * d, d)),
                         ("adaLN_modulation.1.bias", (6 * d,))]:
            sd[f"transformer.{i}.{k}"] = t(shape)
    return sd


def save_lightning_ckpt(sd: dict, path, prefix: str = "shape_model."):
    """`sd` as a Lightning-style checkpoint: {"state_dict": {prefix + k}},
    beside an optimizer entry and a loss module's weights, as a trained
    system's checkpoint carries them."""
    state = {prefix + k: torch.from_numpy(np.asarray(v))
             for k, v in sd.items()}
    state["loss_computer.lpips.weight"] = torch.zeros(3)
    torch.save({"epoch": 3, "global_step": 1000, "state_dict": state,
                "optimizer_states": []}, str(path))
    return str(path)
