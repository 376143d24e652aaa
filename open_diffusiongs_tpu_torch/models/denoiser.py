"""DGS denoiser: posed-image DiT that outputs per-pixel 3D Gaussians.

Counterpart of open_diffusiongs_tpu/models/denoiser.py:41-217, with the
reference's module names (models/denoiser/denoiser.py), so reference
state dicts load with `load_state_dict(strict=True)`:

  object ("relative_plk"):  posed = [rgb*2-1, ray_d, o + (-o.d) d]
    depth = (2 sigmoid(mean(xyz_raw)) - 1) * 1.8 + o.d
  scene ("plk"):            posed = [rgb*2-1, o x d, ray_d]
    depth = sigmoid(mean(xyz_raw)) * (far - near) + near

Head activations follow GaussiansUpsampler.to_gs: scaling =
min(raw - 2.3, -1.2), opacity = raw - 2.0.  Token layout: patch order
(hh ww), feature order (ph pw c), tokens = [n_gaussians free tokens |
v * n_patch image tokens] (denoiser.py:142-144, 193-195, 209-211).

Numerical hazards pinned here: the input LayerNorm and the head
LayerNorms use eps 1e-5 with scale and no bias (denoiser.py:55, 158) and
return f32; with bf16 compute the Linears run in bf16 and `all_gs` returns
to f32 (denoiser.py:180).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.gaussians import Gaussians
from .transformer import DiTStack, LayerNorm32, Linear, TimestepEmbedder, \
    modulate

INIT_STD = 0.02


def gs_channels(sh_degree: int) -> int:
    return 3 + (sh_degree + 1) ** 2 * 3 + 3 + 4 + 1


class Patchify(nn.Module):
    """'b v c (hh ph) (ww pw) -> b (v hh ww) (ph pw c)' (the reference's
    Rearrange at image_tokenizer.0)."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.p = patch_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, v, c, h, w = x.shape
        p = self.p
        x = x.reshape(b, v, c, h // p, p, w // p, p)
        return x.permute(0, 1, 3, 5, 4, 6, 2).reshape(
            b, v * (h // p) * (w // p), p * p * c)


class AdaLNHead(nn.Module):
    """GaussiansUpsampler / ImageTokenDecoder (denoiser.py:76-164):
    LayerNorm (scale, no bias) -> modulate(shift, scale) -> Linear (no
    bias)."""

    def __init__(self, width: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(width, 2 * width, compute_dtype=dtype))
        self.layernorm = LayerNorm32(width, eps=1e-5)
        self.linear = Linear(width, out_features, bias=False,
                             compute_dtype=dtype)

    def forward(self, tokens: torch.Tensor, t_emb: torch.Tensor
                ) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(t_emb).chunk(2, dim=-1)
        return self.linear(modulate(self.layernorm(tokens), shift, scale))


class DGSDenoiser(nn.Module):
    """Image (+ noise) -> per-pixel 3D Gaussians (the x0 predictor)."""

    def __init__(self, width: int = 1024, in_channels: int = 9,
                 patch_size: int = 8, n_gaussians: int = 2,
                 dim_heads: int = 64, num_layers: int = 24,
                 ray_pe_type: str = "relative_plk",
                 hard_pixelalign: bool = True, clip_xyz: bool = True,
                 gaussians_sh_degree: int = 0, rel_depth_scale: float = 1.8,
                 range_setting_near: float = 0.0,
                 range_setting_far: float = 500.0, dtype=torch.float32,
                 gs_raw_offset_scaling: float = 0.0,
                 gs_raw_offset_opacity: float = 0.0,
                 checkpoint: bool = False, attn_impl: str = "auto",
                 quant_int8: bool = False, seq=None, model=None, pipe=None):
        super().__init__()
        if ray_pe_type not in ("relative_plk", "plk"):
            raise ValueError(f"unknown ray_pe_type {ray_pe_type}")
        self.width = width
        self.patch_size = patch_size
        self.n_gaussians = n_gaussians
        self.ray_pe_type = ray_pe_type
        self.hard_pixelalign = hard_pixelalign
        # the [-1, 1] clamp of the pixel-aligned points under training=True
        # on the object PE (JAX denoiser.py:73, 202-203)
        self.clip_xyz = clip_xyz
        self.sh_degree = gaussians_sh_degree
        self.rel_depth_scale = rel_depth_scale
        self.range_setting_near = range_setting_near
        self.range_setting_far = range_setting_far
        self.dtype = dtype
        # additive offsets on the RAW scaling / opacity head outputs: place a
        # random-weights model's population at trained statistics (bench)
        self.gs_raw_offset_scaling = gs_raw_offset_scaling
        self.gs_raw_offset_opacity = gs_raw_offset_opacity
        # serving-mode W8A8 projections in the DiT (ops/quant.py; JAX
        # denoiser.py:95-127): the parameters are the float model's
        self.quant_int8 = quant_int8
        gs_ch = gs_channels(gaussians_sh_degree)

        self.image_tokenizer = nn.Sequential(
            Patchify(patch_size),
            Linear(in_channels * patch_size ** 2, width, bias=False,
                   compute_dtype=dtype))
        self.t_embedder = TimestepEmbedder(width, dtype=dtype)
        # the scene reference stores [1, n, width] (denoiser_scene.py:227)
        pos_shape = ((1, n_gaussians, width) if ray_pe_type == "plk"
                     else (n_gaussians, width))
        self.gaussians_pos_embedding = nn.Parameter(torch.zeros(pos_shape))
        self.transformer_input_layernorm = LayerNorm32(width, eps=1e-5)
        # checkpoint: block recompute in the backward (the reference's
        # use_checkpoint, the JAX package's remat); attn_impl as JAX's
        # (denoiser.py:84): a dim_heads failing the packed lane test takes
        # the general route (models/transformer.py); `seq`, `model`,
        # `pipe`: the run's parallel/mesh.py::Mesh where its sp, tp or pp
        # is > 1 (JAX's sp_mesh, tp_mesh, pp_mesh, denoiser.py:87-94), used
        # by the stack alone: the ops around it run whole on every rank of
        # those axes
        self.transformer = DiTStack(width, width // dim_heads, num_layers,
                                    dtype=dtype, checkpoint=checkpoint,
                                    attn_impl=attn_impl,
                                    quant_int8=quant_int8, seq=seq,
                                    model=model, pipe=pipe)
        self.upsampler = AdaLNHead(width, gs_ch, dtype=dtype)
        self.image_token_decoder = AdaLNHead(width, patch_size ** 2 * gs_ch,
                                             dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: every Linear weight ~ N(0, 0.02), biases
        zero, LayerNorm scales one, and the free-Gaussian position
        embedding from flax's truncated_normal(0.02) (±2σ of a normal
        rescaled so the truncated std is 0.02)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, INIT_STD, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
        std = INIT_STD / 0.87962566103423978
        nn.init.trunc_normal_(self.gaussians_pos_embedding, 0.0, std,
                              -2.0 * std, 2.0 * std, generator=generator)

    def forward(self, images: torch.Tensor, ray_o: torch.Tensor,
                ray_d: torch.Tensor, t: torch.Tensor,
                training: bool = False):
        """images [b, v, 3, h, w] in [0, 1] (view 0 = clean condition);
        ray_o / ray_d [b, v, 3, h, w] world rays (unit ray_d); t [b].
        `training` refuses `quant_int8` (JAX denoiser.py:168) and, with
        `clip_xyz` on the relative_plk PE, clamps the pixel-aligned points
        to [-1, 1] (:202-203); like the reference, the systems never pass
        it.

        Returns (Gaussians with N = n_gaussians + v*h*w, per-pixel
        depth-xyz [b, v, 3, h, w])."""
        b, v, _, h, w = images.shape
        p = self.patch_size
        n = self.n_gaussians
        if training and self.quant_int8:
            # int8 rounding has zero gradient almost everywhere
            raise ValueError("quant_int8 is a serving-mode knob; disable "
                             "it for training (shape_model.quant_int8)")
        if self.ray_pe_type == "relative_plk":
            o_dot_d = torch.sum(-ray_o * ray_d, dim=2, keepdim=True)
            posed = torch.cat([images[:, :, :3] * 2.0 - 1.0, ray_d,
                               ray_o + o_dot_d * ray_d], dim=2)
        else:
            posed = torch.cat([images[:, :, :3] * 2.0 - 1.0,
                               torch.cross(ray_o, ray_d, dim=2), ray_d], dim=2)

        img_tokens = self.image_tokenizer(posed.to(self.dtype))
        t_emb = self.t_embedder(t)
        g_pos = self.gaussians_pos_embedding.reshape(n, self.width)
        x = torch.cat([g_pos[None].expand(b, n, self.width).to(self.dtype),
                       img_tokens], dim=1)
        x = self.transformer_input_layernorm(x)
        x = self.transformer(x, t_emb)

        free_gs = self.upsampler(x[:, :n], t_emb)
        pix_gs = self.image_token_decoder(x[:, n:], t_emb)
        gs_ch = gs_channels(self.sh_degree)
        pix_gs = pix_gs.reshape(b, -1, gs_ch)       # (v hh ww ph pw) order
        all_gs = torch.cat([free_gs, pix_gs], dim=1).float()
        n_pix = pix_gs.shape[1]

        sh_dim = (self.sh_degree + 1) ** 2 * 3
        xyz, feats, scaling, rotation, opacity = torch.split(
            all_gs, [3, sh_dim, 3, 4, 1], dim=2)
        feats = feats.reshape(b, feats.shape[1], -1, 3)
        scaling = torch.clamp(scaling + self.gs_raw_offset_scaling - 2.3,
                              max=-1.2)
        opacity = opacity + self.gs_raw_offset_opacity - 2.0

        hh, ww = h // p, w // p
        # 'b (v hh ww ph pw) c -> b v c (hh ph) (ww pw)'
        pix_xyz = (xyz[:, -n_pix:].reshape(b, v, hh, ww, p, p, 3)
                   .permute(0, 1, 6, 2, 4, 3, 5).reshape(b, v, 3, h, w))
        if self.hard_pixelalign:
            raw_depth = pix_xyz.mean(dim=2, keepdim=True)
            if self.ray_pe_type == "relative_plk":
                depth = ((2.0 * torch.sigmoid(raw_depth) - 1.0)
                         * self.rel_depth_scale + o_dot_d)
                pix_pts = ray_o + depth * ray_d
                if self.clip_xyz and training:
                    pix_pts = pix_pts.clamp(-1.0, 1.0)
            else:
                depth = (torch.sigmoid(raw_depth)
                         * (self.range_setting_far - self.range_setting_near)
                         + self.range_setting_near)
                pix_pts = ray_o + depth * ray_d
            # 'b v c (hh ph) (ww pw) -> b (v hh ww ph pw) c'
            pix_flat = (pix_pts.reshape(b, v, 3, hh, p, ww, p)
                        .permute(0, 1, 3, 5, 4, 6, 2).reshape(b, -1, 3))
            xyz = torch.cat([xyz[:, :-n_pix], pix_flat], dim=1)
            pix_xyz = pix_pts

        return Gaussians(xyz=xyz, features=feats, scaling=scaling,
                         rotation=rotation, opacity=opacity), pix_xyz
