#!/usr/bin/env python3
"""Drive the PyTorch port's object-sampling path, object training step,
the DiT's general attention route (sampling and training), serving from a
checkpoint at 256^2 and 512^2, and the training / evaluation CLI (object
training with resume and export, scene eval with its metric CLI) once on
one NVIDIA GPU, its data, ZeRO-1, sequence, tensor and pipeline
parallelism in two ranks that share the card, the synthetic
G-Objaverse and RE10K generators with a short training run on each tree,
and the four training recipes as their configs define them, LPIPS on.

  python3 chip_smoke.py
  python3 chip_smoke.py --recipe-memory

The second measures each recipe's peak memory against its batch size
instead (whether phase 20 can run it at its own) and runs no phase.

Phases, one summary line each (every failure raises and exits non-zero):
  1. device    card name / power limit (nvidia-smi), torch, CUDA, nvcc and
               triton versions;
  2. build     nvcc builds every kernel from open_diffusiongs_tpu_torch/csrc
               (one nvcc per source, in parallel);
  3. attention the flash-attention kernel against flash_mha_packed_ref on
               bf16 inputs at the 256^2 DiT shape (L = 4098, 16 heads of 64)
               and on a ragged layout (Lp > l_real, garbage pad rows),
               and at the 512^2 shape (L = 16386; the twin runs head by
               head, as everywhere); timed beside its plain twin and
               SDPA's forward, and at L = 16386 beside its bound and SDPA;
  4. blend     the tile-blend kernel against blend_tiles_ref (outputs at
               atol 2e-5; end slots equal but where a stop flips within
               rounding of 1e-4, END_FLIP_*) on three views of the
               random-init denoiser's Gaussians, binned by the port: 256^2
               at init statistics, and 256^2 and 512^2 at trained
               statistics (the raw-head offsets of bench.py:43-51, set
               for the view and restored); timed by CUDA-graph replay and
               as wrapper calls;
               per view the (pixel, candidate) pairs examined and live,
               the warp-candidates walked and culled, mean count and the
               overflow counters;
  5. main path configs/diffusionGS_rel.yaml (width 1024, 24 layers, 30
               steps, 4 views) with random weights from seed 0, through
               DiffusionGSPipeline.batch on extra_files/test_cases/sphere.png
               at 256^2, twice; the second run is timed, split into host
               stages at synchronized edges (preprocess, camera template,
               sampler, transfer, filters, PLY) and its kernel launches
               counted; a third, under torch.profiler, gives device ms per
               asset, the blend and attention kernels' parts, and the host
               and device ms inside the sampler's "denoiser" and "render"
               ranges;
  6. attention training kernels
               the forward-with-lse and the backward kernels against
               flash_mha_packed_ref(with_stats=True) /
               flash_mha_packed_bwd_ref at the train path's shape (b = 4,
               L = 4098, q/k/v column slices of a fused qkv, each batch
               element at its own scale) and on a ragged Lp = 4608
               layout with 1e4 garbage in the pad rows of q/k/v and dO,
               and at the 512^2 train step's shape (b = 1, L = 16386);
               the twins run head by head; bounds, per batch element: o rel-max 8e-3, lse max abs 1e-3
               (base-2 units), dq/dk/dv rel-max 1e-2 each, pad-row grads
               exactly 0; two backward launches on the same inputs must
               agree bit for bit and csrc/flash_attn_bwd.cu must hold no
               atomics; timed beside SDPA's forward at b = 4, its backward
               alone (autograd.grad over a retained graph) and the pair,
               and split by kernel (device ms per call of the hand-written
               kernels and the plain-torch glue, torch.profiler);
  7. blend backward
               the blend backward kernel (bounded by the forward's end
               slots) against blend_bwd_ref on each of phase 4's views
               with mean-squared cotangents against a seeded random target
               (atol 2e-5, rtol 2e-4, and max|err| / max|ref| 1e-5); the
               table gradient d_packed through BlendTiles twice,
               bit-identical; the same rows bit for bit without the end
               slots; timed as phase 4 (phase 4 also counts the (pixel,
               candidate) pairs each view needs, for both blend bounds);
  8. train path
               the same config with system.use_lpips false, random weights
               from seed 0, AdamW / cosine / clip 0.5 / EMA 0.9999 from the
               config, a b = 4 batch of 4 input + 4 supervision views at
               256^2 built in memory, from step 151 (every loss term
               weighted): 1 warm-up step and 3 timed steps; kernel
               launches counted and held against the derived counts; one
               more step under torch.profiler: device ms per step and the
               blend kernels' part;
  9. general attention route
               a. the general-route kernel (flash_full_mha) against its
                  plain twin on bf16 q/k/v slices of a fused qkv at
                  [1, 4098, 16, 64], [1, 4098, 16, 48], [2, 700, 3, 40],
                  [1, 1100, 5, 20] (the wrapper's padded copy), both
                  halves of subset attention (3072 queries over 4098
                  keys, 1026 over 1026) and small shapes off the tiling
                  (FULL_CASES; rel-max 8e-3); q~'s rounding (the helper
                  bit for bit, and the kernel nearer #5's bf16-scale
                  twin than an f32-scale one at 3x scores); its f32 P·V
                  (the kernel nearer the f32-P twin than a bf16-P one,
                  both rounded to bf16); the wrapper's host time per
                  call; registers, spills and wgmma serialisation
                  warnings of its instantiations from the build's
                  -Xptxas -v report (a missing report fails; no
                  warning allowed); the wrapper's device
                  time by kernel (torch.profiler), direct and padded;
                  timed at L = 4098 and 16386 (the plain twin at 4098
                  only: its f32 scores at 16386 would be ~17 GB);
               b. the scalar-max packed forward against its twin (64-row
                  blocks) at b = 1, L = 4098 on a fused qkv and on a ragged
                  Lp = 4608 with 1e4 garbage (rel-max 8e-3), timed;
               c. sampling as phase 5 with shape_model width 768 and
                  dim_heads 48 (16 heads of 48, which fail the packed lane
                  test; no shipped config uses this layout): exactly
                  12 x 30 general-route launches (12 of the 24
                  layers) and none of the packed
                  forward (and the blend launches) in the timed asset,
                  finite renders and Gaussians; then one more asset
                  under torch.profiler: device ms per asset and
                  the general-route kernel's part of it;
               d. 24 DiTBlock(1024, 16, qk_norm=True) at L = 4098, b = 1,
                  bf16, random weights from seed 0: one warm-up and one
                  timed forward, 24 general-route launches, finite output;
               e. the bench variants through tools/bench_attn.py: --check
                  of all four (pv_f32 x score_bf16; rel-max 8e-3 with f32
                  scores, max abs 2e-2 with bf16 scores) and the scalar-max
                  forward, and one timed sweep at L = 4098;
               f. the packed kernels at dh = 16: forward, forward with lse
                  and backward at b = 2, L = 4098, 16 heads of 16 on a fused
                  qkv (per-element scales, phase 6's bounds), and a ragged
                  Lp = 4608;
               g. the packed kernels (forward with and without lse, scalar
                  max, backward) at small and ragged shapes off the main
                  path's tiling, dh 16, 32 and 64 (phase 6's bounds).
  10. load    a full-width checkpoint of configs/diffusionGS_rel_512.yaml's
               denoiser from a seeded generator, in the reference's
               Lightning layout, in a temporary directory (deleted at the
               end): tools/make_pretrained_dir.py and
               DiffusionGSPipeline.from_pretrained load it on the card, and
               every loaded tensor equals its source bit for bit;
  11. 512^2 sampling
               phase 5's path at 512^2 (L = 16386, N = 1,048,578) from that
               pipeline: at init statistics (warm-up, timed with the host
               split, profiled) and at trained statistics through
               from_pretrained's overrides (timed); launches
               exactly 720 and 91, peak memory, the overflow counters;
  12. 512^2 train step
               phase 8 at 512^2, b = 1, from the 512^2 config with
               system.weights set to phase 10's directory (three of its
               tensors checked as loaded), no profiled step.
  13. launch train
               object training through open_diffusiongs_tpu_torch.launch
               in process: a G-Objaverse tree of 4 objects x 40 views at
               512^2 (smooth shapes on white; PNG + json + zip `_nd.exr`,
               written with the port's utils/exr.py) in a temporary
               directory; configs/diffusionGS_rel.yaml at its own b = 4 and
               num_workers 4 with the overrides it prints (paths,
               use_lpips false, one trial dir, an eval at step 4, only the
               forced final saves, a log line every step of the first
               run): --train --max_steps 4, a resume to 6, --export of one
               object from the last checkpoint.  Gates: metrics.csv steps
               1..5; the eval after the restore equals the eval at the
               save bit for bit; a parameter, its EMA and its Adam moment
               restored bit for bit; finite losses; each call's launches
               equal the derived counts (per step 48 / 24 / 40 / 40 of
               #1s / #3 / #2 / #4 with 4 + 6 views, eval passes apart);
               export's PLY, PNG and AVI.  Printed: phase 8's step in
               memory at 4 + 6 views (its own gates), the loader alone over
               8 batches, seconds per step with the loader in the loop
               and the loop's wait on the loader in each,
               peak memory, checkpoint bytes and save / restore seconds,
               overflow_frac, each call's collector seconds;
  14. scene eval
               launch --validate of configs/diffusionGS_scene_eval.yaml at
               its eval_batch_size 16 (random weights from seed 0) on an
               RE10K tree of 16 scenes x 8 frames at 360 x 640, one batch,
               then open_diffusiongs_tpu_torch.eval_scene_result on the
               dumps.  Gates: 16 npz dumps, trajectory videos, PLY + path
               videos, val_metrics.json; the launches equal the derived
               counts (720 #1; 16 x 91 + 16 x 31 #2); finite PSNR / SSIM
               over 16 scenes.  Printed: seconds for the batch and per
               scene split at synchronized edges into load, sampler,
               dumps (npz + grid PNG), trajectory videos and PLY + path
               video, peak memory, the overflow counters.  Then LPIPS:
               the port's tools/convert_lpips_weights.py writes an NPZ
               from synthetic full-spec torchvision-VGG16 and lpips-head
               state dicts (torch.save, seeded), the metric CLI runs again
               with --lpips-weights and prints lpips beside PSNR / SSIM,
               and one scene's LPIPS on the card is held against the CPU
               (rtol 2e-4).
  15. serving surface
               a. the density stage on a synthetic shell of 20k
                  Gaussians at resolution 128 (the twin on every slab),
                  phase 5's filtered Gaussians and phase 11's
                  trained-statistics 512^2 Gaussians at 256 (every 8th
                  slab; the latter's field has a surface on those planes):
                  gaussian_density_grid split into host seconds (inputs,
                  selection, field, copy); the card's selection
                  (slab_select) equal to slab_tables's numpy loop; the
                  kernel (csrc/density_grid.cu) with its cull
                  bit-identical to the kernel without it and to the path's
                  grid, against density_grid_ref (atol 1e-5 + rtol 1e-5,
                  and iso crossings at 0.005 within 0.01 %); the live
                  pairs (kernel counters; the twin's count on its slabs),
                  evaluated pairs and box tests, the bound these inputs
                  need (live pairs at 25 f32 operations and one exp each,
                  or the packed lists and the grid at the HBM rate) beside
                  the all-pairs bound (every pair of the lists, as the
                  first design evaluated them), the kernel by CUDA events
                  with the cull on and off, on all slabs and on the
                  twin's, the twin's time; the kernel's live-pair count on
                  the twin's slabs within 1e-6 of the twin's, its counted
                  launch's grid bit-identical to the plain launch's; what
                  the port's tie rule changes (capped slabs whose list
                  under np.argsort's default, JAX's call, differs from the
                  stable one, in order or membership, and the kernel's
                  grid from those lists against the port's);
               b. extract_mesh on the 300-Gaussian ball of
                  tests/test_mesh.py:74-93 at 256 under its bars, the
                  kernel grid's mesh against the twin grid's (vertex
                  counts within 0.1 %, symmetric Hausdorff <= one voxel),
                  save_mesh_obj; pipe.batch(extract_mesh=True) on phase
                  5's input with phase 5's system (one density launch) and
                  the host split of its mesh (density inputs / selection /
                  field / copy, marching tets / clean + repair + remesh /
                  largest component / decimate / OBJ); the same split for
                  phase 11's trained-statistics 512^2 Gaussians, meshed
                  from 15a's grid of them;
               c. W8A8: one 256^2 asset with quant_int8 (phase 5's weights
                  and seed; seconds and device ms of the same call, traced
                  by torch.profiler's CUDA activity; exactly 24 x 4 x 30
                  int8 products), its renders' PSNR against phase 5's, and
                  QuantLinear against the bf16 Linear at M = 4098 and
                  16386 beside their bounds (int8 at 1,979 TOPS);
               d. U²-Net (full spec, synthetic weights in a temporary NPZ):
                  u2net_alpha at 320^2 timed, the card's d0 against the CPU
                  (max 1.5e-3, mean 1e-5); then run.main with --matting
                  u2net --extract-mesh and U2NET_NPZ set: PLY, renders and
                  a non-empty mesh.obj.
  16. general-route training
               a. #5s (flash_full_mha_stats: flash_full_fwd.cu's STATS
                  flag) and #5b (flash_full_mha_bwd: flash_full_bwd.cu)
                  against their twins (run head by head) at
                  GENERAL_TRAIN_CASES: b = 4, L = 4098, 16 heads of 64
                  and of 48 on column slices of a fused qkv, 64 also on
                  contiguous q / k (the qk_norm blocks' RMSNorm outputs),
                  d 40 and 20, both halves of subset attention, shapes
                  off the tiling; each batch element at its own scale;
                  phase 6's bounds (o rel-max 8e-3, lse abs 1e-3, dq/dk/dv
                  rel-max 1e-2); two backward launches bit-identical;
                  flash_full_bwd.cu free of atomics; q~ on the card equal
                  to bf16(q * bf16(d^-1/2)) and, at 3x scores, the
                  kernel's o on the training twin, not on #5's serving
                  twin; ptxas: no spills, no wgmma serialisation warnings
                  in the STATS and backward instantiations; timed by
                  CUDA events at d 64 and 48 beside SDPA's forward, its
                  backward alone, the twins and the bounds, the backward
                  split by kernel;
               b. 24 DiTBlock(1024, 16, qk_norm=True) forward + backward
                  at b = 4, L = 4098, bf16: exactly 24 #5s and 24 #5b
                  launches and no other attention launch, finite, non-zero
                  gradients;
               c. phase 8's train step with shape_model width 768 and
                  dim_heads 48 (16 heads of 48, all 24 layers, block
                  checkpointing): per step 48 #5s, 24 #5b and no packed
                  launch, plus the blends; finite losses, the EMA moves;
                  seconds and device ms per step, peak memory.
  17. data, ZeRO-1 and sequence parallelism
               a. #1s and #3 with split query / key extents against their
                  twins (head by head) at the ring's shapes: Lp = 4608 at
                  sp = 2 and 4 (b = 2) and Lp = 16896 at sp = 2 (b = 1),
                  a full query shard against the tail's keys and the tail
                  against a full shard, 1e4 in the rows past each extent;
                  phase 6's bounds, dq rows >= lq_real and dk / dv rows
                  >= lk_real and lse rows >= lq_real exactly 0; the
                  forward's and the backward's f32 outputs (the ring's)
                  rounding to their bf16 ones bit for bit; equal extents
                  bit-identical to the
                  one-extent launch; one
                  ring step of the 512^2 sp = 2 shape timed;
               b. two ranks sharing the card over gloo (spawned
                  processes, a file rendezvous): (i) DDP at dp = 2 on
                  configs/diffusionGS_rel.yaml at 256^2, 2 samples a rank,
                  against the one-process b = 4 step on the same batch
                  and draws (rank 0 runs it first): loss rel 1e-3,
                  grad_norm, the averaged gradients and the update (where
                  |g| >= 0.1 of its tensor's max) rel-max 1e-2; (ii)
                  ZeRO-1 against that DDP over two steps bit for bit
                  (params, EMA, moments, grad_norm), moment and EMA bytes
                  and a step's peak device bytes per rank; (iii) sp = 2
                  on the 512^2 config at b = 1 against the one-process
                  step: loss rel 1e-3, grad_norm
                  and the DiT's no-grad output rel-max 1e-2; tensor by
                  tensor against an f32 reference step (the model in f32,
                  attention by SDPA), the averaged gradients (rel-max and
                  rel-L2) and the update (rel-max) no further from it than
                  the one-process step is, beyond 1e-2 (their distance
                  to the one-process step printed); per rank exactly
                  layers x sp x 2 #1s and layers x sp #3 a step and
                  layers x sp #1s a DiT pass; (iv) `launch --train` with
                  trainer.zero1 on the two ranks (a 2-object tree, 2
                  steps): rank 1 writes nothing, and the checkpoint
                  restores on one process bit for bit; each world's
                  seconds per step beside the one-process step, labelled
                  as two processes sharing one card, not as scaling.
  18. tensor and pipeline parallelism, serving over data ranks: two ranks
      sharing the card over gloo (spawned, `parallel18_rank`), on
      configs/diffusionGS_rel.yaml at 256^2, b = 4, against the
      one-process step and an f32 step (rank 0 runs both first):
               i. tp = 2: loss rel 1e-4; the gradients and the update
                  (every rank's part put together) no further from the f32
                  step than the one-process step is, beyond 1e-2 (17b's
                  yardstick); per rank 48 #1s and 24 #3 a step on 8 heads;
                  the bytes summed over `model` a step equal to 6 x layers
                  [4, 4098, 1024] bf16 tensors; parameter and Adam moment
                  bytes per rank;
               ii. pp = 2 (12 layers a stage, two microbatches of 2): the
                  same gates, 48 #1s and 24 #3 per rank a step;
               iii. dp = 2 serving: DiffusionGSPipeline.batch(mesh=) of
                  two images, each element's renders >= 50 dB PSNR against
                  the one-process batch of both (xyz rel-max and the
                  bit-equal share printed); 720 #1 and 91 #2 per rank;
                  both ranks return the same whole list;
               each case's seconds per step beside the one-process step,
               labelled as two processes sharing one card, not as
               scaling.  ZeRO-1 x tp = 2 (four ranks) is a CPU test only.
  19. synthetic trees
               a. the port's generators (tools/make_synthetic_objaverse.py:
                  one object of 256 Gaussians, 40 views at 64^2;
                  tools/make_synthetic_re10k.py: one room at wall step
                  0.5 with 4 lobes, 5 frames at 64^2) on the card and on
                  the CPU: alpha, rgb x alpha, and rgb and ray depth where
                  both alphas > 0.3 (the object), rgb (the scene) within
                  atol 2e-5; the PNG bytes within 1 LSB; the overflow
                  counters and binned entries equal; 40 blend launches an
                  object, one a frame; then at full size, where the
                  object's capacities clip (both counters nonzero): views
                  0, 8, 28, 39 of a 4,096-Gaussian object at 256^2 (D = 16,
                  K = 512) and the first 8 frames of b's room (wall step
                  0.18, 10 lobes; D = 256, K = 4096), card against CPU:
                  the counters equal, at most 0.1 % of the pixels apart
                  beyond the same bars, and each apart pixel a threshold
                  flip (it agrees once the CPU's 1/255 skip or 1e-4 stop
                  moves by 0.1 %); one blend launch a view;
               b. 2 objects and 1 scene of 48 frames at 256^2 written on
                  the card (seconds per object and per scene, their
                  counters), then launch --train for 20 steps with an
                  eval every 10 on each tree with its recipe
                  (configs/diffusionGS_rel.yaml, 4 + 6 views;
                  configs/diffusionGS_scene.yaml, 4 input + 7 rendered
                  views; docs/CONVERGENCE.md's b = 1, LPIPS off, lr 5e-5):
                  finite metrics, eval rows at 0, 10 and 20, launches
                  equal the derived counts; losses, eval PSNR, seconds a
                  step, overflow counters and peak memory printed.
  20. the recipes as configured
               the train step of each training config
               (configs/diffusionGS_rel.yaml, _rel_512, _scene, _scene_512)
               at its own batch_size (each fits 80 GB: --recipe-memory),
               training resolution and views (4 + 6 rendered objects, 4 + 3 + 4
               = 7 rendered scene frames), with
               system.use_lpips=true system.allow_random_lpips=true (the
               random-frozen VGG16 of lpips_init_params): from step 151
               (lambda_lpips 0.5 for objects, 0.1 for scenes), 1 warm-up
               + 3 timed steps + 1 profiled (device ms); s/step, device
               ms, the idle share, the "lpips" range's device ms (CUDA
               events at its edges, the timed steps' median), peak
               memory, b configured beside b run; launches
               equal 48 #1s / 24 #3 / b·views #2 / b·views #4 a step; the
               LPIPS term alone (forward + the render's backward) timed
               by CUDA events on the step's shapes.  On the object
               recipe's batch: LPIPS on the card against the CPU on 8
               render / target pairs (value rtol 2e-4, gradient with
               respect to the render rel-max 1e-3, both devices on the
               card's ReLU / max-pool decisions, lpips_routed: a flat
               render ties every pool window, where the gradient is not
               unique); the DiT's gradients at
               step 151 with lambda_lpips 0.5 against 0.0 (must differ by
               more than two identical steps do; whether those two are bit
               for bit is printed); the LPIPS term timed again with
               cudnn.allow_tf32 switched on, then restored, beside its
               deviation from the f32 value (a number, not a setting).
Timed host windows (phases 5, 8, 11, 12) report the seconds the garbage
collector ran inside them; each profiler session's garbage is collected
as soon as it is read, outside them.
Then the host split of one 256^2 and one 512^2 asset, each phase's host
seconds, the kernels' JSON line (each kernel's launches on its main path, max
abs error, ms, plain ms, bound ms and what sets it, from this run's shapes
and data at the H100's published peaks, and the one-call PyTorch time or
null; the blend rows at the init view, with their trained-statistics times
and bounds beside; the 512^2 launches of each main-path kernel beside its
256^2 ones), the card line, and the result line {"ok": true,
"device": {...}}.
Imports nothing of JAX.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "diffusionGS_rel.yaml")
CONFIG_512 = os.path.join(ROOT, "configs", "diffusionGS_rel_512.yaml")
# phase 12 checks these tensors came from phase 10's checkpoint
SPOT_CHECK = ("transformer.0.attn.qkv.weight", "upsampler.linear.weight",
              "image_token_decoder.linear.weight")
IMAGE = os.path.join(ROOT, "extra_files", "test_cases", "sphere.png")

ATTN_REL_BOUND = 8e-3    # max|err| / max|ref| in bf16 (the TPU kernel's bar)
LSE_ABS_BOUND = 1e-3     # base-2 log-sum-exp, max abs
GRAD_REL_BOUND = 1e-2    # dq / dk / dv max|err| / max|ref| in bf16
BLEND_ABS_BOUND = 2e-5   # the rasterizer's forward parity bar (atol)
BLEND_BWD_TOL = dict(atol=2e-5, rtol=2e-4)   # tests/test_rasterize.py:307-326
# dg max|err| / max|ref|, free of the loss's scale: f32 sums over a tile's
# 256 pixels in another order agree to ~1e-6 of the largest row
BLEND_BWD_REL_BOUND = 1e-5
RES = 256
RES_512 = 512
N_VIEWS = 4
STEPS = 30
TRAIN_BATCH = 4          # the config's per-device batch_size
TRAIN_START_STEP = 151   # every C()-scheduled loss term at full weight
TRAIN_STEPS = 3          # timed, after one warm-up step
QKV_SCALES = (1.0, 0.6, 1.4, 0.8)   # phase 6, one per batch element
GENERAL_SAMPLING_LAYERS = 12          # phase 9c's depth
DO_SCALES = (1.0, 2.0, 0.5, 1.5)
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).  A
# kernel's bound is the larger of its operations over the peak rate of
# their type and its bytes (each input read once, each output written
# once) over the memory rate.
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# f32 operations of the blend: every examined (pixel, candidate) pair
# needs the power (11), the exponential and alpha (3) and the transmittance
# test (2); a live pair (one the pixel blends) adds, in the forward, its
# colour and depth (4 multiply-adds) and, in the backward re-walk, the
# gradient of alpha and of the candidate's 10 attributes (~40
# multiply-adds, csrc/blend_bwd.cu).
BLEND_OPS_PER_PAIR = 16
BLEND_FWD_OPS_PER_LIVE_PAIR = 8
BLEND_BWD_OPS_PER_LIVE_PAIR = 80
# End slots of the forward kernel and its twin may differ only where a
# pixel's stop flips between the kernel's sequential transmittance product
# and the twin's prefix products: at the earlier of the two slots
# |T (1 - alpha) - 1e-4| / 1e-4, with T walked in float64, stays below
# this (f32 products over ~1000 factors drift by < 1e-4 relative), and
# such pixels are few.
END_FLIP_REL_BOUND = 1e-3
END_FLIP_MAX_PIXELS = 64


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn()'s launches, replayed from a CUDA
    graph `iters` times: the kernels' time without the host's (a wrapper
    that takes longer on the host than its kernel on the card would
    otherwise time the host)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class GcClock:
    """Seconds the cyclic garbage collector runs while the context is open
    (gc.callbacks): host time a timed window spent on garbage that is not
    the window's own work."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def collect_garbage() -> float:
    """A full garbage collection now, and its seconds.  Called once a
    torch.profiler session is dropped: its events (~10 Python objects
    each, in reference cycles) are garbage that only a full collection
    frees, which would otherwise run seconds long inside a later timed
    window."""
    t0 = time.perf_counter()
    gc.collect()
    return time.perf_counter() - t0


def bound(ops: dict, nbytes: float) -> dict:
    """bound_ms and what sets it, from operations by type and bytes."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attn_fwd_bound(b, lp, l_real, h, dh, stats=False, pv="bf16") -> dict:
    """Packed / general attention forward: q·kᵀ in bf16 and P·V in `pv`
    over keys < l_real; q and o of Lp rows, k and v of l_real rows, bf16;
    the lse in f32."""
    prod = 2 * b * h * lp * l_real * dh
    ops = {"bf16": 2 * prod} if pv == "bf16" else {"bf16": prod, pv: prod}
    nbytes = 2 * (2 * b * lp + 2 * b * l_real) * h * dh
    return bound(ops, nbytes + (4 * b * lp * h if stats else 0))


def attn_bwd_bound(b, lp, l_real, h, dh) -> dict:
    """Packed backward: the 5 products the function needs (S, dP, dQ, dK,
    dV) over real rows and keys; q, k, v, o, dO and the lse read on real
    rows, dq / dk / dv written whole."""
    ops = {"bf16": 5 * 2 * b * h * l_real * l_real * dh}
    nbytes = 2 * (5 * b * l_real + 3 * b * lp) * h * dh + 4 * b * l_real * h
    return bound(ops, nbytes)


def device_ms_by_kernel(torch, fn, iters: int = 10,
                        warm_up: bool = True) -> dict:
    """Device ms per call of each kernel fn() launches, by torch.profiler,
    largest first, under its name cut to 60 characters (empty if the
    profiler sees no device time).  One unprofiled call first unless the
    caller has warmed fn up."""
    from torch.profiler import ProfilerActivity, profile
    if warm_up:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|at::native::",
                          "", e.key)[:60]
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / iters)
    del prof
    collect_garbage()
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def blend_walk(torch, packed, idx, counts, tiles_x, tile_chunk=16):
    """What this view's blend needs: per (tile, pixel), the candidates the
    pixel examines front to back (through its stopping one, or all
    counts[t]); the transmittance test is taken in log space, so a pixel
    right at the 1e-4 threshold may count one candidate more or less than
    the kernel's sequential product.  Returns (examined pairs, rows read:
    per tile the candidates up to its deepest pixel, live pairs: those a
    pixel blends, in front of its stop)."""
    num_tiles, k = idx.shape
    pix = torch.arange(256, device=idx.device)
    slot = torch.arange(k, device=idx.device)
    pairs = rows = live_pairs = 0
    for t0 in range(0, num_tiles, tile_chunk):
        t = torch.arange(t0, min(t0 + tile_chunk, num_tiles),
                         device=idx.device)
        a = packed[idx[t].long()]                                # [t, K, 10]
        px = ((t % tiles_x) * 16)[:, None] + pix % 16            # [t, 256]
        py = ((t // tiles_x) * 16)[:, None] + pix // 16
        dx = a[:, None, :, 0] - px[..., None].float()            # [t, 256, K]
        dy = a[:, None, :, 1] - py[..., None].float()
        power = (-0.5 * (a[:, None, :, 2] * dx * dx
                         + a[:, None, :, 4] * dy * dy)
                 - a[:, None, :, 3] * dx * dy)
        alpha = torch.clamp(a[:, None, :, 8] * torch.exp(power), max=0.99)
        live = slot < counts[t][:, None]                          # [t, K]
        valid = (power <= 0) & (alpha >= 1 / 255) & live[:, None, :]
        log_t = torch.cumsum(torch.where(valid, torch.log1p(-alpha), 0.0),
                             -1)
        stop = valid & (log_t < torch.log(torch.tensor(1e-4)))
        first = torch.where(stop.any(-1), stop.float().argmax(-1) + 1,
                            counts[t][:, None].long())
        pairs += int(first.sum())
        rows += int(first.amax(-1).sum())
        live_pairs += int((valid & (torch.cumsum(stop.int(), -1) == 0))
                          .sum())
    return pairs, rows, live_pairs


def phase_device(torch) -> dict:
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True)
    nvcc_ver = (nvcc.stdout.strip().splitlines() or ["?"])[-1] \
        if nvcc.returncode == 0 else "nvcc not on PATH"
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not installed"
    info = {"card": card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc_ver,
            "triton": triton_ver}
    print(f"[1 device] {json.dumps(info)}", flush=True)
    return info


def phase_build() -> float:
    from open_diffusiongs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    secs = time.perf_counter() - t0
    nvcc = ("cached build reused" if _build.BUILD_SECONDS is None
            else f"nvcc {_build.BUILD_SECONDS:.2f} s")
    print(f"[2 build] kernels ready in {secs:.2f} s ({nvcc}) -> "
          f"{_build.build_dir()}", flush=True)
    return secs


def twin_by_head(torch, twin, h, dh, *tensors, **kw):
    """A plain attention twin run one head at a time, on each head's column
    slice of its packed [b, Lp, h*dh] inputs (and the head's column of an
    lse [b, Lp, h]), its outputs joined in the packed layout again: the
    twin's result for all heads with one head's f32 score matrices alive
    at a time (~1 GB each at L = 16386, where all 16 heads' are ~17 GB)."""
    parts = []
    for i in range(h):
        out = twin(*(x[..., i:i + 1] if x.shape[-1] == h
                     else x[..., i * dh:(i + 1) * dh] for x in tensors),
                   num_heads=1, **kw)
        parts.append(out if isinstance(out, tuple) else (out,))
    joined = tuple(torch.cat(p, -1) for p in zip(*parts))
    return joined if len(joined) > 1 else joined[0]


def attention_case(torch, dev, gen, b, l_real, lp, h, dh, fused: bool,
                   scalar_max: bool = False):
    """Kernel vs plain version (run head by head) on bf16 inputs; rows >=
    l_real hold 1e4."""
    from open_diffusiongs_tpu_torch.ops import attention
    hd = h * dh
    qkv = torch.randn((b, lp, 3 * hd), generator=gen, device=dev,
                      dtype=torch.float32).to(torch.bfloat16)
    qkv[:, l_real:] = 1e4                       # garbage pad rows
    if fused:       # column slices of one qkv projection, as in the DiT
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        q, k, v = (x.contiguous() for x in qkv.chunk(3, dim=-1))
    kw = dict(num_heads=h, l_real=l_real)
    if scalar_max:
        kw["scalar_max"] = True
    out = attention.flash_mha_packed(q, k, v, **kw)
    ref = twin_by_head(torch, attention.flash_mha_packed_ref, h, dh, q, k, v,
                       **{n: x for n, x in kw.items() if n != "num_heads"})
    torch.cuda.synchronize()
    o, r = out[:, :l_real].float(), ref[:, :l_real].float()
    if not torch.isfinite(o).all():
        raise AssertionError("attention kernel: non-finite real rows")
    err = float((o - r).abs().max())
    rel = err / float(r.abs().max())
    return err, rel, (q, k, v), kw


def phase_attention(torch, dev) -> dict:
    import torch.nn.functional as F

    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(0)
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    err, rel, (q, k, v), kw = attention_case(torch, dev, gen, 1, l, l, 16,
                                             64, fused=True)
    err_r, rel_r, _, _ = attention_case(torch, dev, gen, 1, l, 4608, 16, 64,
                                        fused=False)
    ms = cuda_ms(lambda: attention.flash_mha_packed(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: attention.flash_mha_packed_ref(q, k, v, **kw),
                       3)
    q4, k4, v4 = (x.reshape(1, l, 16, 64).transpose(1, 2) for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
    # the 512^2 DiT's shape (L = 16386): against the twin, and timed
    # beside its bound and SDPA
    l5 = 2 + N_VIEWS * (RES_512 // 8) ** 2
    err5, rel5, (q5, k5, v5), kw5 = attention_case(torch, dev, gen, 1, l5,
                                                   l5, 16, 64, fused=True)
    ms5 = cuda_ms(lambda: attention.flash_mha_packed(q5, k5, v5, **kw5), 10)
    q5, k5, v5 = (x.reshape(1, l5, 16, 64).transpose(1, 2)
                  for x in (q5, k5, v5))
    sdpa_ms5 = cuda_ms(lambda: F.scaled_dot_product_attention(q5, k5, v5),
                       10)
    res = {"max_abs_err": err, "rel_max_err": rel,
           "ragged_max_abs_err": err_r, "ragged_rel_max_err": rel_r,
           "ms": ms, "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
           **attn_fwd_bound(1, l, l, 16, 64),
           "shape": f"b=1 L={l} h=16 dh=64 bf16",
           f"max_abs_err_L{l5}": err5, f"rel_max_err_L{l5}": rel5,
           f"ms_L{l5}": ms5, f"sdpa_ms_L{l5}": sdpa_ms5,
           f"bound_ms_L{l5}": attn_fwd_bound(1, l5, l5, 16, 64)["bound_ms"]}
    print(f"[3 attention] {json.dumps(res)}", flush=True)
    for name, r in (("L=4098", rel), ("ragged Lp=4608", rel_r),
                    (f"L={l5}", rel5)):
        if not r <= ATTN_REL_BOUND:
            raise AssertionError(f"attention kernel {name}: rel-max error "
                                 f"{r:.3g} > {ATTN_REL_BOUND}")
    return res


def build_system(torch, dev, config=CONFIG, overrides=()):
    """The config's system on `dev`: random init from seed 0, then the
    config's own weight bootstraps (load_pretrained)."""
    from open_diffusiongs_tpu_torch.systems.builder import build_system
    from open_diffusiongs_tpu_torch.utils.config import load_config
    cfg = load_config(config, cli_args=list(overrides), makedirs=False)
    system = build_system(cfg.system_type, cfg.system, device=dev)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    system.load_pretrained()
    return system


def trained_stat_offsets(res: int):
    """Raw-head offsets that place a random-weights model's Gaussians at
    trained statistics (bench.py:43-51): ~1.5 px footprints at the orbit
    camera (depth ~3, fov 40 degrees), opacity ~ sigmoid(1)."""
    import math
    f = 0.5 * res / math.tan(math.radians(40.0) / 2)
    return math.log(1.5 * 3.0 / f) + 2.3, 3.0


def blend_view(torch, dev, system, res: int, trained: bool = False) -> dict:
    """One res^2 view of a random-init denoiser's Gaussians (t = T-1 step,
    view 1), preprocessed and binned by the port; with `trained` the
    denoiser's raw-head offsets are set to trained statistics for the
    view and restored after it."""
    from PIL import Image

    from open_diffusiongs_tpu_torch.ops import camera as cam_lib
    from open_diffusiongs_tpu_torch.ops import gs_math
    from open_diffusiongs_tpu_torch.ops import rasterize as rz
    from open_diffusiongs_tpu_torch.ops.rays import rays_chw
    from open_diffusiongs_tpu_torch.pipeline import (object_camera_template,
                                                     preprocess_image)
    cond = preprocess_image(Image.open(IMAGE), 0.85, res, matting="border")
    c2ws, fxy = object_camera_template(N_VIEWS, h=res, w=res)
    c2w = torch.from_numpy(c2ws).to(dev)[None]
    fxy_t = torch.from_numpy(fxy).to(dev)[None]
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.cat([torch.from_numpy(cond).to(dev)[None, None],
                        torch.randn((1, N_VIEWS - 1, 3, res, res),
                                    generator=gen, device=dev)], 1)
    ray_o, ray_d = rays_chw(c2w, fxy_t, res, res)
    t = torch.as_tensor(system.sched_infer.timestep_map[-1:], device=dev)
    model = system.model
    saved = (model.gs_raw_offset_scaling, model.gs_raw_offset_opacity)
    if trained:
        (model.gs_raw_offset_scaling,
         model.gs_raw_offset_opacity) = trained_stat_offsets(res)
    try:
        with torch.no_grad():
            g, _ = model(images, ray_o, ray_d, t)
    finally:
        model.gs_raw_offset_scaling, model.gs_raw_offset_opacity = saved
    act = rz.Gaussians(*(x[0] for x in g)).activate()
    cov3d = gs_math.build_cov3d(act.scaling, act.rotation)
    cam = cam_lib.CameraParams(*(x[0, 1] for x in cam_lib.make_camera(
        c2w, fxy_t, res, res)))
    pre = rz.preprocess_view(act, cov3d, cam, res, res, g.sh_degree)
    pre, _ = rz._clip_rect_centered(pre, system.cfg.raster
                                    .max_tiles_per_gaussian)
    tiles_x = res // rz.TILE
    bins = rz._bin_tiles_single(pre, tiles_x, tiles_x, system.cfg.raster,
                                grad_map=True)
    return {"name": f"{'trained' if trained else 'init'} {res}^2",
            "packed": rz.pack_rows(pre).detach(), "bins": bins,
            "tiles_x": tiles_x, "res": res}


def blend_culls(torch, view, n_end) -> dict:
    """Warp-candidates the kernels walk and those the cull removes: per
    warp the forward walks slots up to its deepest pixel's end slot
    (through it when that pixel stopped), the backward up to it."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel
    bins = view["bins"]
    mask = blend_kernel.cull_mask(view["packed"], bins.idx, bins.counts,
                                  view["tiles_x"])                # [T, 8, K]
    wend = n_end[:, blend_kernel.warp_pixels(n_end.device)].amax(-1).long()
    counts = bins.counts[:, None].long()
    slot = torch.arange(bins.idx.shape[1], device=n_end.device)
    out = {}
    for name, walked in (("fwd", torch.minimum(wend + 1, counts)),
                         ("bwd", wend)):
        inside = slot < walked[..., None]
        out[f"{name}_warp_candidates"] = int(inside.sum())
        out[f"{name}_warp_candidates_culled"] = int((mask & inside).sum())
        out[f"{name}_longest_warp_walk"] = int(walked.max())
        out[f"{name}_longest_warp_walk_after_cull"] = int(
            (inside & ~mask).sum(-1).max())
    return out


def end_slot_flips(torch, view, n_end, n_end_ref) -> list:
    """|T (1 - alpha) - 1e-4| / 1e-4 at the earlier end slot of each pixel
    whose end slots differ between the kernel and its twin: alpha in f32
    as the kernels form it, T the product in front of it in float64.  A
    stop that flips by rounding reads near 0; a wrong end slot does not."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel as bk
    packed, idx, tiles_x = view["packed"], view["bins"].idx, view["tiles_x"]
    out = []
    for t, p in (n_end != n_end_ref).nonzero().tolist():
        s = int(min(n_end[t, p], n_end_ref[t, p]))
        a = packed[idx[t, :s + 1].long()]
        dx = a[:, 0] - float((t % tiles_x) * bk.TILE + p % bk.TILE)
        dy = a[:, 1] - float((t // tiles_x) * bk.TILE + p // bk.TILE)
        power = (-0.5 * (a[:, 2] * dx * dx + a[:, 4] * dy * dy)
                 - a[:, 3] * dx * dy)
        alpha = torch.clamp(a[:, 8] * torch.exp(power), max=bk.ALPHA_MAX)
        blend = (power <= 0) & (alpha >= bk.ALPHA_MIN)
        one_minus = torch.where(blend, 1.0 - alpha.double(), 1.0)
        test_t = one_minus[:-1].prod() * one_minus[-1]
        out.append(float((test_t - bk.EARLY_STOP_T).abs() / bk.EARLY_STOP_T)
                   if bool(blend[-1]) else float("inf"))
    return out


def blend_fwd_case(torch, view) -> dict:
    """The forward kernel against blend_tiles_ref on one view (outputs and
    end slots), timed beside the plain twin."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel
    packed, bins, tiles_x = view["packed"], view["bins"], view["tiles_x"]
    args = (packed, bins.idx, bins.counts, tiles_x)
    out = blend_kernel.blend_tiles(*args, return_end=True)
    ref = blend_kernel.blend_tiles_ref(*args, return_end=True)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(out[:3], ref[:3])]
    n_flips = int((out[3] != ref[3]).sum())
    flips = (end_slot_flips(torch, view, out[3], ref[3])
             if n_flips <= END_FLIP_MAX_PIXELS else [])
    ms = graph_ms(lambda: blend_kernel.blend_tiles(*args), 50)
    wrapper_ms = cuda_ms(lambda: blend_kernel.blend_tiles(*args), 20)
    plain_ms = cuda_ms(lambda: blend_kernel.blend_tiles_ref(*args), 2)
    pairs, rows, live = blend_walk(torch, packed, bins.idx, bins.counts,
                                   tiles_x)
    n_tiles = bins.idx.shape[0]
    # candidate rows (10 f32) and their indices, counts; t_fin, acc_c (3),
    # acc_d and n_end written per pixel
    nbytes = rows * 44 + n_tiles * 4 + n_tiles * 256 * 6 * 4
    view.update(n_end=out[3], fwd=out[:3], pairs=pairs, rows=rows,
                live=live)
    res = {"view": view["name"], "max_abs_err": max(errs),
           "err_t_fin": errs[0], "err_acc_c": errs[1], "err_acc_d": errs[2],
           "n_end_mismatch_pixels": n_flips,
           "n_end_mismatch_rel_gap": flips,
           "ms": ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "examined_pairs": pairs,
           "live_pairs": live, "rows_read": rows,
           **blend_culls(torch, view, out[3]),
           **bound({"f32": pairs * BLEND_OPS_PER_PAIR
                    + live * BLEND_FWD_OPS_PER_LIVE_PAIR}, nbytes),
           "shape": f"T={n_tiles} K={bins.idx.shape[1]} "
                    f"N={packed.shape[0] - 1}",
           "mean_count": float(bins.counts.float().mean()),
           "overflow_gaussians": int(bins.overflow_gaussians),
           "overflow_tiles": int(bins.overflow_tiles)}
    print(f"[4 blend] {json.dumps(res)}", flush=True)
    if not max(errs) <= BLEND_ABS_BOUND:
        raise AssertionError(f"blend kernel, {view['name']}: max abs error "
                             f"{max(errs):.3g} > {BLEND_ABS_BOUND}")
    if not (n_flips <= END_FLIP_MAX_PIXELS
            and all(g <= END_FLIP_REL_BOUND for g in flips)):
        raise AssertionError(f"blend kernel, {view['name']}: {n_flips} end "
                             f"slots differ from the twin's, not by a stop "
                             f"within rounding of 1e-4: {flips}")
    return res


def phase_blend(torch, dev, system):
    """The forward kernel on one 256^2 view at init statistics and on a
    256^2 and a 512^2 view at trained statistics."""
    views = [blend_view(torch, dev, system, RES),
             blend_view(torch, dev, system, RES, trained=True),
             blend_view(torch, dev, system, 2 * RES, trained=True)]
    return [blend_fwd_case(torch, v) for v in views], views


def rel_max(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def attention_train_case(torch, dev, gen, l_real, lp, h=16, dh=64,
                         b=TRAIN_BATCH, plain_fwd=False):
    """Stats forward + backward, kernel vs plain, at the train path's batch
    on bf16 column slices of a fused qkv; rows >= l_real of qkv and dO hold
    1e4.  Each batch element has its own scale of qkv and of dO, so a
    kernel that read another element's rows, lse or delta would be off by
    far more than the bounds; errors are relative per element.
    `plain_fwd` also holds the stats-free forward."""
    from open_diffusiongs_tpu_torch.ops import attention
    qkv = torch.randn((b, lp, 3 * h * dh), generator=gen, device=dev)
    do = torch.randn((b, lp, h * dh), generator=gen, device=dev)
    qkv *= torch.tensor(QKV_SCALES[:b], device=dev)[:, None, None]
    do *= torch.tensor(DO_SCALES[:b], device=dev)[:, None, None]
    qkv, do = qkv.to(torch.bfloat16), do.to(torch.bfloat16)
    qkv[:, l_real:] = 1e4
    do[:, l_real:] = 1e4
    q, k, v = qkv.chunk(3, dim=-1)
    kw = dict(num_heads=h, l_real=l_real)
    o, lse = attention.flash_mha_packed(q, k, v, with_stats=True, **kw)
    o_r, lse_r = twin_by_head(torch, attention.flash_mha_packed_ref, h, dh,
                              q, k, v, l_real=l_real, with_stats=True)
    grads = attention.flash_mha_packed_bwd(q, k, v, o, do, lse, **kw)
    refs = twin_by_head(torch, attention.flash_mha_packed_bwd_ref, h, dh,
                        q, k, v, o, do, lse, l_real=l_real)
    torch.cuda.synchronize()

    def rel(out, ref):          # the worst batch element
        return max(rel_max(out[i], ref[i]) for i in range(b))

    res = {"o_rel_max": rel(o[:, :l_real], o_r[:, :l_real]),
           "lse_max_abs": float((lse - lse_r)[:, :l_real].abs().max()),
           "lse_pad_zero": bool((lse[:, l_real:] == 0).all())}
    if plain_fwd:
        res["o_plain_rel_max"] = rel(
            attention.flash_mha_packed(q, k, v, **kw)[:, :l_real],
            o_r[:, :l_real])
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not torch.isfinite(g).all():
            raise AssertionError(f"attention backward: non-finite {name}")
        res[f"{name}_rel_max"] = rel(g, r)
        res[f"{name}_max_abs"] = float((g.float() - r.float()).abs().max())
        res[f"{name}_pad_zero"] = bool((g[:, l_real:] == 0).all())
    del o_r, lse_r, refs
    return res, (q, k, v, o, do, lse, kw)


def phase_attention_train(torch, dev) -> dict:
    import torch.nn.functional as F

    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(2)
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    full, (q, k, v, o, do, lse, kw) = attention_train_case(torch, dev, gen,
                                                            l, l)
    ragged, _ = attention_train_case(torch, dev, gen, l, 4608)
    # the 512^2 train step's shape (phase 12): b = 1, L = 16386
    l5 = 2 + N_VIEWS * (RES_512 // 8) ** 2
    full_512, _ = attention_train_case(torch, dev, gen, l5, l5, b=1)
    torch.cuda.empty_cache()
    b = TRAIN_BATCH
    fwd_ms = cuda_ms(lambda: attention.flash_mha_packed(
        q, k, v, with_stats=True, **kw), 20)
    fwd_plain_ms = cuda_ms(lambda: attention.flash_mha_packed_ref(
        q, k, v, with_stats=True, **kw), 3)
    bwd_ms = cuda_ms(lambda: attention.flash_mha_packed_bwd(
        q, k, v, o, do, lse, **kw), 20)
    bwd_plain_ms = cuda_ms(lambda: attention.flash_mha_packed_bwd_ref(
        q, k, v, o, do, lse, **kw), 3)
    fwd_split = device_ms_by_kernel(torch, lambda: attention.flash_mha_packed(
        q, k, v, with_stats=True, **kw))
    bwd_split = device_ms_by_kernel(torch, lambda: attention
                                    .flash_mha_packed_bwd(q, k, v, o, do,
                                                          lse, **kw))
    # q~ as the wrappers form it: bf16(f32(q) * f32(scale)), bit for bit
    prescale_exact = torch.equal(
        attention._prescaled_q(q, 64),
        (q.float() * (64 ** -0.5 * attention.LOG2E)).to(torch.bfloat16))
    # Determinism: the backward writes every output once, in a fixed order
    # (no atomics), so two launches on the same inputs agree bit for bit.
    g1 = attention.flash_mha_packed_bwd(q, k, v, o, do, lse, **kw)
    g2 = attention.flash_mha_packed_bwd(q, k, v, o, do, lse, **kw)
    bit_identical = all(torch.equal(x, y) for x, y in zip(g1, g2))
    del g1, g2
    with open(os.path.join(ROOT, "open_diffusiongs_tpu_torch", "csrc",
                           "flash_attn_bwd.cu")) as f:
        bwd_source_atomic_free = "atomic" not in f.read().lower()
    # one PyTorch call per function: SDPA's forward at b = 4, its backward
    # alone (autograd.grad over a retained graph), and the pair
    q4, k4, v4 = (x.reshape(b, l, 16, 64).transpose(1, 2).detach()
                  .requires_grad_(True) for x in (q, k, v))
    do4 = do.reshape(b, l, 16, 64).transpose(1, 2)
    with torch.no_grad():
        sdpa_fwd_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
    out4 = F.scaled_dot_product_attention(q4, k4, v4)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), 20)
    del out4
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4), 20)
    res = {"full": full, "ragged_lp4608": ragged, f"b1_L{l5}": full_512,
           "fwd_stats_ms": fwd_ms, "fwd_stats_plain_ms": fwd_plain_ms,
           "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
           "fwd_stats_kernels_ms": fwd_split, "bwd_kernels_ms": bwd_split,
           "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
           "sdpa_fwd_bwd_ms": sdpa_ms,
           "fwd_stats_bound": attn_fwd_bound(b, l, l, 16, 64, stats=True),
           "bwd_bound": attn_bwd_bound(b, l, l, 16, 64),
           "bwd_bit_identical": bit_identical,
           "prescaled_q_exact": prescale_exact,
           "bwd_source_atomic_free": bwd_source_atomic_free,
           "shape": f"b={b} L={l} h=16 dh=64 bf16, fused qkv"}
    print(f"[6 attention training kernels] {json.dumps(res)}", flush=True)
    if not bit_identical:
        raise AssertionError("attention backward: dq/dk/dv differ between "
                             "two launches on the same inputs")
    if not prescale_exact:
        raise AssertionError("q~ on the card differs from bf16(f32(q) * "
                             "f32(scale))")
    if not bwd_source_atomic_free:
        raise AssertionError("csrc/flash_attn_bwd.cu uses atomics")
    cases = (("L=4098", full), ("ragged Lp=4608", ragged),
             (f"b=1 L={l5}", full_512))
    for case, r in cases:
        checks = [("o rel-max", r["o_rel_max"], ATTN_REL_BOUND),
                  ("lse max abs", r["lse_max_abs"], LSE_ABS_BOUND)]
        checks += [(f"{n} rel-max", r[f"{n}_rel_max"], GRAD_REL_BOUND)
                   for n in ("dq", "dk", "dv")]
        for name, val, bound in checks:
            if not val <= bound:
                raise AssertionError(f"attention training {case}: {name} "
                                     f"{val:.3g} > {bound}")
        for n in ("lse", "dq", "dk", "dv"):
            if not r[f"{n}_pad_zero"]:
                raise AssertionError(f"attention training {case}: {n} pad "
                                     f"rows are not exactly 0")
    res["max_abs_err_fwd"] = max(r["lse_max_abs"] for _, r in cases)
    res["max_abs_err_bwd"] = max(r[f"{n}_max_abs"] for _, r in cases
                                 for n in ("dq", "dk", "dv"))
    return res


def blend_bwd_case(torch, dev, view) -> dict:
    """Cotangents of the mean-squared error of the view's render, alpha and
    depth against a seeded random target; the backward kernel (bounded by
    the forward's end slots) vs its plain twin, and the table gradient
    through BlendTiles twice."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel
    from open_diffusiongs_tpu_torch.ops import rasterize as rz
    packed, bins, tiles_x = view["packed"], view["bins"], view["tiles_x"]
    res_px = view["res"]
    gen = torch.Generator(device=dev).manual_seed(3)
    target = torch.rand((res_px, res_px, 5), generator=gen, device=dev)
    bg = torch.ones(3, device=dev)

    def l2(t_fin, acc_c, acc_d):     # mean-squared, as the training loss
        c, a, d = rz.blend_tiles_g(t_fin, acc_c, acc_d, tiles_x, tiles_x, bg)
        return (((c - target[..., :3]) ** 2).mean()
                + ((a - target[..., 3]) ** 2).mean()
                + ((d - target[..., 4]) ** 2).mean())

    fwd = view["fwd"]
    leaves = [x.clone().requires_grad_(True) for x in fwd]
    cot = torch.autograd.grad(l2(*leaves), leaves)
    args = (packed, bins.idx, bins.counts, *fwd, *cot, tiles_x)
    n_end = view["n_end"]
    dg = blend_kernel.blend_bwd(*args, n_end=n_end)
    dg_unbounded = blend_kernel.blend_bwd(*args)
    ref = blend_kernel.blend_bwd_ref(*args)
    torch.cuda.synchronize()
    err = (dg - ref).abs()
    excess = float((err - BLEND_BWD_TOL["rtol"] * ref.abs()).max())

    def table_grad():
        p = packed.clone().requires_grad_(True)
        out = blend_kernel.BlendTiles.apply(p, bins.idx, bins.counts,
                                            bins.gidx, tiles_x)
        return torch.autograd.grad(l2(*out), p)[0]

    d1, d2 = table_grad(), table_grad()
    ms = graph_ms(lambda: blend_kernel.blend_bwd(*args, n_end=n_end), 50)
    wrapper_ms = cuda_ms(lambda: blend_kernel.blend_bwd(*args, n_end=n_end),
                         20)
    plain_ms = cuda_ms(lambda: blend_kernel.blend_bwd_ref(*args), 1)
    n_tiles, k = bins.idx.shape
    pairs, rows, live = view["pairs"], view["rows"], view["live"]
    # candidate rows and indices, counts, 10 f32 of forward outputs and
    # cotangents and the end slot per pixel read; dg [T, K, 10] f32
    # written
    nbytes = (rows * 44 + n_tiles * 4 + n_tiles * 256 * 11 * 4
              + n_tiles * k * 10 * 4)
    res = {"view": view["name"], "max_abs_err": float(err.max()),
           "examined_pairs": pairs, "live_pairs": live, "rows_read": rows,
           **bound({"f32": pairs * BLEND_OPS_PER_PAIR
                    + live * BLEND_BWD_OPS_PER_LIVE_PAIR}, nbytes),
           "max_ref": float(ref.abs().max()),
           "rel_max_err": float(err.max() / ref.abs().max()),
           "max_err_minus_rtol_ref": excess,
           "without_end_slots_bit_identical": bool(torch.equal(
               dg, dg_unbounded)),
           "nonzero_rows": int((dg != 0).any(-1).sum()),
           "d_packed_bit_identical": bool(torch.equal(d1, d2)),
           "d_packed_finite": bool(torch.isfinite(d1).all()),
           "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "shape": f"T={n_tiles} K={k} N={packed.shape[0] - 1}"}
    print(f"[7 blend backward] {json.dumps(res)}", flush=True)
    name = view["name"]
    if not excess <= BLEND_BWD_TOL["atol"]:
        raise AssertionError(f"blend backward, {name}: |err| - rtol*|ref| "
                             f"= {excess:.3g} > atol "
                             f"{BLEND_BWD_TOL['atol']}")
    if not res["rel_max_err"] <= BLEND_BWD_REL_BOUND:
        raise AssertionError(f"blend backward, {name}: rel-max error "
                             f"{res['rel_max_err']:.3g} > "
                             f"{BLEND_BWD_REL_BOUND}")
    if not res["without_end_slots_bit_identical"]:
        raise AssertionError(f"blend backward, {name}: the rows bounded by "
                             f"the end slots differ from the unbounded ones")
    if res["nonzero_rows"] == 0:
        raise AssertionError(f"blend backward, {name}: every gradient row "
                             f"is zero")
    if not (res["d_packed_bit_identical"] and res["d_packed_finite"]):
        raise AssertionError(f"blend backward, {name}: d_packed differs "
                             f"between two runs or is not finite")
    return res


def phase_blend_bwd(torch, dev, views) -> list:
    """The backward kernel on phase 4's three views."""
    return [blend_bwd_case(torch, dev, v) for v in views]


def train_batch(torch, dev, b: int, res: int, sup_views: int = N_VIEWS):
    """b objects of 4 input views and `sup_views` supervision views (the
    input views first) at res^2, in memory: uniform images from a numpy
    seed, the object camera template, depth 3.0, masks of ones."""
    import numpy as np

    from open_diffusiongs_tpu_torch.pipeline import object_camera_template
    v, sv = N_VIEWS, sup_views
    c2ws, fxy = object_camera_template(sv, h=res, w=res)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    cams = dict(c2ws=t(np.broadcast_to(c2ws, (b, sv, 4, 4))),
                fxfycxcys=t(np.broadcast_to(fxy, (b, sv, 4))))
    return {
        "rgbs_input": t(rng.uniform(size=(b, v, 3, res, res))),
        "c2ws_input": cams["c2ws"][:, :v],
        "fxfycxcys_input": cams["fxfycxcys"][:, :v],
        "depths_input": torch.full((b, v, 1, res, res), 3.0, device=dev),
        "masks_input": torch.ones((b, v, 1, res, res), device=dev),
        "rgbs": t(rng.uniform(size=(b, sv, 3, res, res))),
        "masks": torch.ones((b, sv, 1, res, res), device=dev), **cams,
    }


def phase_train(torch, dev, label="8 train path", config=CONFIG,
                overrides=(), profile=True, loaded=None,
                sup_views: int = N_VIEWS, after=None) -> dict:
    """The train step of `config` (+ dotlist `overrides`) on a batch of the
    config's per-device batch_size objects at its training_res: 1 warm-up
    and TRAIN_STEPS timed steps
    from step 151, launches held against the derived counts, and (with
    `profile`) one more step under torch.profiler.  `loaded`: tensors by
    name that the config's weight bootstraps must have loaded.  The EMA must move on
    every watched tensor that got a gradient (a tensor moved only by
    weight decay moves by about an ulp, which the EMA's 1e-4 step rounds
    away).  `after(system, batch)`, when given, runs last, its result
    under "after"."""
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer, make_train_step)
    from open_diffusiongs_tpu_torch.systems.builder import (
        build_optimizer_config, build_system)
    from open_diffusiongs_tpu_torch.utils.config import load_config
    # no LPIPS weights ship with the repo (as bench.py:108 runs it)
    cfg = load_config(config, cli_args=["system.use_lpips=false",
                                        *overrides], makedirs=False)
    batch_size, res = cfg.data["batch_size"], cfg.data["training_res"][0]
    system = build_system(cfg.system_type, cfg.system, device=dev)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    system.load_pretrained()
    model = system.model
    params = dict(model.named_parameters())
    for name, value in (loaded or {}).items():
        if not torch.equal(params[name], value):
            raise AssertionError(f"{name} was not loaded by the config's "
                                 f"weight bootstraps")
    opt_cfg = build_optimizer_config(cfg.system, cfg.trainer)
    optimizer = make_optimizer(opt_cfg, params.items())
    state = init_train_state(params, optimizer, ema_decay=0.9999)
    state.step = TRAIN_START_STEP
    gen = torch.Generator(device=dev).manual_seed(7)
    train_step = make_train_step(
        lambda batch, step: system.train_loss(batch, step, generator=gen),
        optimizer, ema_decay=0.9999)
    batch = train_batch(torch, dev, batch_size, res, sup_views)

    state, _ = train_step(state, batch)                    # warm-up
    torch.cuda.synchronize()
    watch = ["transformer.0.attn.qkv.weight", "upsampler.linear.weight",
             "image_token_decoder.linear.weight"]
    before = {k: params[k].detach().clone() for k in watch}
    ema_before = {k: state.ema_params[k].clone() for k in watch}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(attention, blend_kernel)
    steps = []
    for _ in range(TRAIN_STEPS):
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            state, m = train_step(state, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        steps.append({"seconds": secs, "gc_seconds": gc_clock.seconds,
                      "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "lr": optimizer.lr()})
    launches = {"attention_fwd": attention.LAUNCHES,
                "attention_fwd_lse": attention.LAUNCHES_STATS,
                "attention_bwd": attention.LAUNCHES_BWD,
                "general_fwd": attention.LAUNCHES_FULL,
                "general_fwd_lse": attention.LAUNCHES_FULL_STATS,
                "general_bwd": attention.LAUNCHES_FULL_BWD,
                "blend_fwd": blend_kernel.LAUNCHES,
                "blend_bwd": blend_kernel.LAUNCHES_BWD}
    # Per step: every DiT layer runs its attention's stats forward twice
    # under block checkpointing (the forward and the backward's recompute;
    # once without) and its backward once, on the packed kernels (#1s,
    # #3) or, for a layout that fails the lane test, the general route's
    # (#5s, #5b); the render blends (and back-propagates) each of the
    # b x 4 supervision views once.
    n_layers = len(model.transformer)
    fwd = n_layers * (2 if model.transformer.checkpoint else 1)
    route = ("attention" if model.transformer[0].attn.packed
             else "general")
    views = batch_size * sup_views
    want = {k: 0 for k in launches}
    want.update({f"{route}_fwd_lse": TRAIN_STEPS * fwd,
                 f"{route}_bwd": TRAIN_STEPS * n_layers,
                 "blend_fwd": TRAIN_STEPS * views,
                 "blend_bwd": TRAIN_STEPS * views})
    qkv_grad_norms = [float(model.transformer[i].attn.qkv.weight.grad.norm())
                      for i in range(n_layers)]
    # image_token_decoder makes 262,144 of the 262,146 Gaussians (one per
    # pixel); the 2 free ones (upsampler) can sit behind the nearest-K cut
    # of every tile at init statistics and then get no gradient
    head_grad = {k: float(params[k].grad.norm()) for k in watch[1:]}
    secs = sum(s["seconds"] for s in steps) / len(steps)
    out = {"steps": steps, "seconds_per_step": secs,
           "batch_size": batch_size, "samples_per_second": batch_size / secs,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": launches, "expected_launches": want,
           "overflow_gaussians": int(m["overflow_gaussians"]),
           "overflow_tiles": int(m["overflow_tiles"]),
           "overflow_frac": float(m["overflow_frac"]),
           "loss_terms": {k: float(m[k]) for k in m if k.startswith("loss_")},
           "psnr": float(m["psnr"]),
           "min_qkv_grad_norm": min(qkv_grad_norms),
           "head_grad_norms": head_grad,
           "param_change": {k: float((params[k].detach() - before[k])
                                     .abs().max())
                            for k in watch},
           "ema_change": {k: float((state.ema_params[k] - ema_before[k])
                                   .abs().max()) for k in watch},
           "batch": f"b={batch_size}, {N_VIEWS}+{sup_views} views at "
                    f"{res}^2, from step {TRAIN_START_STEP}",
           "config": os.path.relpath(config, ROOT),
           "overrides": list(overrides), "card": card_line()}
    t_profile = time.perf_counter()
    if profile:
        # device time of one more step, and the kernels' parts of it
        by_kernel = device_ms_by_kernel(
            torch, lambda: train_step(state, batch), iters=1, warm_up=False)
        out.update(device_ms_per_step=sum(by_kernel.values()),
                   blend_fwd_device_ms_per_step=kernel_ms(
                       by_kernel, "blend_fwd_kernel"),
                   blend_bwd_device_ms_per_step=kernel_ms(
                       by_kernel, "blend_bwd_kernel"),
                   attention_fwd_device_ms_per_step=kernel_ms(
                       by_kernel, "flash_full_kernel" if route == "general"
                       else "flash_fwd_kernel"),
                   attention_bwd_device_ms_per_step=kernel_ms(
                       by_kernel, "flash_full_bwd" if route == "general"
                       else "flash_bwd"))
    if after is not None:
        t_after = time.perf_counter()
        out["after"] = after(system, batch)
        out.update(profile_seconds=t_after - t_profile,
                   after_seconds=time.perf_counter() - t_after)
    print(f"[{label}] {json.dumps(out)}", flush=True)
    if not all(torch.isfinite(torch.tensor(s["loss"])) for s in steps):
        raise AssertionError("non-finite training loss")
    if not all(torch.isfinite(p).all() for p in params.values()):
        raise AssertionError("non-finite parameters after training")
    if not min(qkv_grad_norms) > 0:
        raise AssertionError(f"zero qkv gradient in a DiT layer: "
                             f"{qkv_grad_norms}")
    if not head_grad["image_token_decoder.linear.weight"] > 0:
        raise AssertionError(f"zero Gaussian-head gradient: {head_grad}")
    if not min(out["param_change"].values()) > 0:
        raise AssertionError(f"params did not change: {out['param_change']}")
    graded = [k for k in watch if k not in head_grad or head_grad[k] > 0]
    if not min(out["ema_change"][k] for k in graded) > 0:
        raise AssertionError(f"EMA did not move: {out['ema_change']}")
    if launches != want:
        raise AssertionError(f"train kernel launches {launches} != {want}")
    return out


def profile_asset(torch, fn) -> dict:
    """One call of fn() under torch.profiler (host and device): device ms
    by kernel (device events only: a host op's device time repeats its
    kernels'), and per named range of the sampler ("denoiser": the DiT's
    eager launches; "render": the rasterizer and its glue) the host ms
    spent inside it, the device ms of the kernels launched inside it and
    the device span from its first kernel to its last.  The profiler
    adds its own host cost to every operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_kernel, ranges = {}, {}
    for e in prof.key_averages():
        if e.key in ("denoiser", "render"):
            r = ranges.setdefault(e.key, {})
            if e.device_type == DeviceType.CPU:
                r.update(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                         kernel_ms=e.device_time_total / 1e3)
            else:
                r["device_span_ms"] = e.device_time_total / 1e3
        elif (e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0):
            name = re.sub(r"^void |\(anonymous namespace\)::|at::native::",
                          "", e.key)[:60]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.self_device_time_total / 1e3)
    del prof
    return {"wall_s": wall, "by_kernel": by_kernel, "ranges": ranges,
            "device_ms": sum(by_kernel.values()),
            "free_profile_s": collect_garbage()}


def host_split(stages: dict, prof: dict) -> dict:
    """One asset's host seconds by pipeline stage (synchronized edges)
    and the sampler's device-busy time (kernel time summed over the
    profiled asset, one stream) beside it."""
    busy = prof["device_ms"] / 1e3
    return {"stages_s": stages, "total_s": sum(stages.values()),
            "sampler_device_busy_s": busy,
            "sampler_device_idle_share": 1.0 - busy / stages["sampler"],
            "profiled_asset_wall_s": prof["wall_s"],
            "profiled_ranges": prof["ranges"]}


def check_asset(out, res: int, header: str = None) -> None:
    """Finite renders of the expected shape and finite Gaussians, the
    PLY's header naming them when one was written, and overflow counters
    that were counted (binned entries > 0)."""
    import numpy as np
    g = out.gaussians
    if list(out.renders.shape) != [N_VIEWS, 3, res, res]:
        raise AssertionError(f"renders shape {out.renders.shape}")
    if not np.isfinite(out.renders).all():
        raise AssertionError("non-finite renders")
    if not all(np.isfinite(x).all() for x in g):
        raise AssertionError("non-finite Gaussians")
    if header is not None and f"element vertex {g.xyz.shape[0]}" not in header:
        raise AssertionError("PLY not written as expected")
    if not (out.stats["binned_entries"] > 0
            and min(out.stats.values()) >= 0):
        raise AssertionError(f"overflow counters {out.stats}")


def sample_asset(torch, dev, pipe, res: int, label: str,
                 profiled: bool = True, warm_up: bool = True,
                 keep: list = None) -> dict:
    """DiffusionGSPipeline.batch on IMAGE at res^2: a warm-up call, a
    timed call (host clock, ending in synchronize; stages split at
    synchronized edges; launches counted, the int8 products of a
    quant_int8 model too; peak memory; PLY written), and with `profiled`
    one more call under torch.profiler.  The timed call's output is
    appended to `keep` when given."""
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel, quant
    kw = dict(resolution=res, n_views=N_VIEWS, matting="border")
    if warm_up:
        pipe.batch([IMAGE], **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "sphere.ply")
        reset_launches(attention, blend_kernel, quant)
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            out = pipe.batch([IMAGE], save_ply=[ply], stage_seconds=stages,
                             **kw)[0]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = {"attention": attention.LAUNCHES,
                    "blend": blend_kernel.LAUNCHES,
                    "int8_mm": quant.LAUNCHES}
        others = {n: v for m in (attention, blend_kernel)
                  for n, v in launch_counts(m).items()
                  if n != "LAUNCHES" and v}
        ply_bytes = os.path.getsize(ply)
        with open(ply, "rb") as f:
            header = f.read(4096).split(b"end_header")[0].decode("ascii")
    n_layers = len(pipe.system.model.transformer)
    want = {"attention": n_layers * STEPS,
            "blend": (STEPS - 1) * (N_VIEWS - 1) + N_VIEWS,
            # q/k/v, proj, fc1, fc2 of every block at every step
            "int8_mm": (n_layers * 4 * STEPS
                        if pipe.system.model.quant_int8 else 0)}
    res_out = {"seconds_per_asset": secs, "gc_seconds": gc_clock.seconds,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated(dev),
               "launches": launches, "expected_launches": want,
               "gaussians_after_filters": int(out.gaussians.xyz.shape[0]),
               "renders_shape": list(out.renders.shape),
               "overflow": out.stats, "ply_bytes": ply_bytes,
               "card": card_line()}
    if profiled:
        # the device's share of one more asset (kernel time summed over
        # the asset: one stream, so busy time) and the blend's part of it
        prof = profile_asset(torch, lambda: pipe.batch([IMAGE], **kw))
        res_out.update(device_ms_per_asset=prof["device_ms"],
                       blend_device_ms_per_asset=kernel_ms(
                           prof["by_kernel"], "blend_fwd_kernel"),
                       attention_device_ms_per_asset=kernel_ms(
                           prof["by_kernel"], "flash_fwd_kernel"),
                       free_profile_s=prof["free_profile_s"],
                       host_split=host_split(stages, prof))
    else:
        res_out["stages_s"] = stages
    print(f"[{label}] {json.dumps(res_out)}", flush=True)
    check_asset(out, res, header)
    if keep is not None:
        keep.append(out)
    if launches != want or others:
        raise AssertionError(f"kernel launches {launches} (others "
                             f"{others}) != {want}")
    return res_out


def phase_main(torch, dev, system, keep: list) -> dict:
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    return sample_asset(torch, dev, DiffusionGSPipeline(system), RES,
                        "5 main path", keep=keep)


def synthetic_reference_ckpt(torch, dev, config: str, path: str) -> dict:
    """A full-width checkpoint of `config`'s denoiser in the reference's
    Lightning layout ({"state_dict": {"shape_model." + name: tensor}}),
    made on the card from a seeded generator and written to `path`:
    LayerNorm scales 1 + N(0, 0.02), every other tensor N(0, 0.02).
    Returns the source tensors (on the card) by reference name."""
    from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
    from open_diffusiongs_tpu_torch.systems.builder import shape_model_kwargs
    from open_diffusiongs_tpu_torch.utils.config import load_config
    cfg = load_config(config, makedirs=False)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in DGSDenoiser(**shape_model_kwargs(
            cfg.system["shape_model"])).state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    src = {}
    for name, shape in shapes.items():
        w = 0.02 * torch.randn(shape, generator=gen, device=dev)
        src[name] = w + 1.0 if "layernorm" in name else w
    torch.save({"epoch": 0, "global_step": 0, "state_dict": {
        "shape_model." + k: v.cpu() for k, v in src.items()}}, path)
    return src


def phase_load(torch, dev, tmp: str):
    """10: a full-width reference checkpoint -> make_pretrained_dir ->
    DiffusionGSPipeline.from_pretrained, on the card; every loaded tensor
    equals its source bit for bit."""
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    from open_diffusiongs_tpu_torch.tools.make_pretrained_dir import \
        make_pretrained_dir
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "obj_ckpt_512.ckpt")
    src = synthetic_reference_ckpt(torch, dev, CONFIG_512, ckpt)
    ckpt_bytes = os.path.getsize(ckpt)
    t1 = time.perf_counter()
    out = make_pretrained_dir(CONFIG_512, ckpt, os.path.join(tmp, "obj_512"),
                              device=dev)
    os.remove(ckpt)
    t2 = time.perf_counter()
    pipe = DiffusionGSPipeline.from_pretrained(out, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    state = pipe.system.model.state_dict()
    differ = [k for k in src if not torch.equal(state[k], src[k])]
    res = {"tensors": len(src),
           "parameters": sum(v.numel() for v in src.values()),
           "ckpt_bytes": ckpt_bytes,
           "pretrained_dir_bytes": sum(
               os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(out) for f in fs),
           "write_ckpt_s": t1 - t0, "make_pretrained_dir_s": t2 - t1,
           "from_pretrained_s": t3 - t2, "differing_tensors": differ[:5],
           "config": os.path.relpath(CONFIG_512, ROOT), "card": card_line()}
    print(f"[10 load] {json.dumps(res)}", flush=True)
    if set(state) != set(src) or differ:
        raise AssertionError(f"loaded weights differ from the source: "
                             f"{differ[:5]} (keys equal: "
                             f"{set(state) == set(src)})")
    if pipe.system.device != dev or state["transformer.0.attn.qkv.weight"
                                         ].device != dev:
        raise AssertionError("from_pretrained did not load onto the card")
    return res, pipe, out, {k: src[k] for k in SPOT_CHECK}


def phase_sample_512(torch, dev, pipe, pretrained: str, keep: list) -> dict:
    """11: 512^2 sampling from the loaded pipeline at init statistics
    (warm-up, timed, profiled) and, through from_pretrained's overrides,
    at trained statistics (timed; its output appended to `keep`)."""
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    init = sample_asset(torch, dev, pipe, RES_512, "11 512^2 sampling, init")
    scaling, opacity = trained_stat_offsets(RES_512)
    overrides = [f"system.shape_model.gs_raw_offset_scaling={scaling!r}",
                 f"system.shape_model.gs_raw_offset_opacity={opacity!r}"]
    del pipe
    torch.cuda.empty_cache()
    trained_pipe = DiffusionGSPipeline.from_pretrained(
        pretrained, device=dev, overrides=overrides)
    if trained_pipe.system.model.gs_raw_offset_opacity != opacity:
        raise AssertionError("trained-statistics override not applied")
    # no warm-up: every kernel, cuBLAS plan and cached block of this
    # shape was made by the init asset's three calls
    trained = sample_asset(torch, dev, trained_pipe, RES_512,
                           "11 512^2 sampling, trained statistics",
                           profiled=False, warm_up=False, keep=keep)
    return {"init": init, "trained": dict(trained, overrides=overrides)}


def phase_train_512(torch, dev, pretrained: str, spot: dict) -> dict:
    """12: one 512^2 train step of configs/diffusionGS_rel_512.yaml at
    b = 1 (4 + 4 views, from step 151; 1 warm-up + 3 timed), its weights
    loaded by the config's `system.weights` from phase 10's directory."""
    return phase_train(torch, dev, "12 512^2 train step", CONFIG_512,
                       overrides=(f"system.weights={pretrained}",),
                       profile=False, loaded=spot)


def kernel_ms(by_kernel: dict, prefix: str) -> float:
    return sum(ms for name, ms in by_kernel.items()
               if name.startswith(prefix))


def roof(res: dict) -> dict:
    return {"bound_ms": res["bound_ms"], "bound_by": res["bound_by"]}


def trained_times(cases: list) -> dict:
    """A blend row's times and bounds on the trained-statistics views."""
    return {f"{k}_{c['view'].replace('^2', '').replace(' ', '_')}": c[k]
            for c in cases[1:] for k in ("ms", "bound_ms")}


def reset_launches(*modules) -> None:
    """Every launch counter of the given kernel modules to 0."""
    for m in modules:
        for name in dir(m):
            if name.startswith("LAUNCHES"):
                setattr(m, name, 0)


def launch_counts(m) -> dict:
    return {n: getattr(m, n) for n in dir(m) if n.startswith("LAUNCHES")}


def fused_heads(torch, dev, gen, b, l, h, d):
    """q, k, v [b, l, h, d] bf16: column slices of one fused qkv, viewed per
    head as the DiT's general route hands them to the kernel."""
    qkv = torch.randn((b, l, 3 * h * d), generator=gen, device=dev
                      ).to(torch.bfloat16)
    return tuple(x.reshape(b, l, h, d) for x in qkv.chunk(3, dim=-1))


def ptxas_summary(log: str, entry: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name holds
    `entry`, from an `nvcc -Xptxas -v` log, under its template arguments."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if entry in m.group(1) else None
            if name:
                args = re.search(r"ILi(\d+)ELb([01])ELb([01])E"
                                 r"(?:Lb([01])E)?", name)
                kern = re.search(r"([a-z_]+_kernel)ILi(\d+)E", name)
                if args:
                    name = "DH={} split={} score_bf16={}".format(
                        *args.groups()[:3])
                    name += " stats=1" if args.group(4) == "1" else ""
                elif kern:
                    name = "{} DH={}".format(*kern.groups())
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if name and m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def full_twin_on(torch, qs, k, v, p_bf16: bool = False):
    """flash_full_mha_ref's softmax and P·V (f32) on a given q~; with
    p_bf16, P is rounded to bf16 before P·V (the row sum stays f32)."""
    s = torch.einsum("blhd,bmhd->bhlm", qs.float(), k.float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    return (torch.einsum("bhlm,bmhd->blhd", pv, v.float())
            / p.sum(-1).transpose(1, 2)[..., None])


# 9a: (b, l, h, d, q0, q1, lk): queries q0:q1 over keys :lk of a fused qkv
# [b, l, 3 h d]: the route's shapes (d 48 / 40 in a 64-wide tile, d 20
# through the padded copy), both halves of subset attention (s = 1026),
# and shapes off the kernel's tiling (one consumer warpgroup, one query,
# one key, d = 8)
FULL_CASES = ((1, 4098, 16, 64, 0, 4098, 4098),
              (1, 4098, 16, 48, 0, 4098, 4098),
              (2, 700, 3, 40, 0, 700, 700), (1, 1100, 5, 20, 0, 1100, 1100),
              (1, 4098, 16, 64, 1026, 4098, 4098),
              (1, 4098, 16, 64, 0, 1026, 1026),
              (1, 70, 3, 64, 0, 70, 70), (2, 129, 2, 32, 0, 129, 129),
              (1, 300, 2, 64, 298, 300, 300), (1, 1, 2, 64, 0, 1, 1),
              (3, 200, 2, 8, 0, 200, 200))


def phase_general_kernel(torch, dev) -> dict:
    """9a: flash_full_mha vs flash_full_mha_ref at the route's shapes, the
    kernel's q~ rounding, its build (registers, spills, wgmma
    serialisation warnings) and the wrapper's device time by kernel."""
    from open_diffusiongs_tpu_torch.ops import _build, attention
    gen = torch.Generator(device=dev).manual_seed(4)
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    cases = {}
    for b, n, h, d, q0, q1, lk in FULL_CASES:
        q, k, v = fused_heads(torch, dev, gen, b, n, h, d)
        q, k, v = q[:, q0:q1], k[:, :lk], v[:, :lk]
        name = f"{b}x{n}x{h}x{d}"
        if (q0, q1, lk) != (0, n, n):
            name += f" queries {q0}:{q1} over {lk} keys"
        out = attention.flash_full_mha(q, k, v)
        ref = attention.flash_full_mha_ref(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_full_mha {name}: non-finite")
        cases[name] = {
            "rel_max_err": rel_max(out, ref),
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "tma_reads_views": all(attention.full_takes_view(
                x.data_ptr(), x.shape, x.stride(), x.element_size())
                for x in (q, k, v))}
        del out, ref
    # q~ = bf16(q * bf16(scale)): the wrapper's helper equals the kernel's
    # arithmetic (f32 product of two bf16 values, rounded once) bit for
    # bit, and at scores large enough to tell the two roundings apart the
    # kernel sits on #5's (bf16 scale) twin, not on one that rounds the
    # scale and the product once from f32 (the packed path's q~).
    q, k, v = fused_heads(torch, dev, gen, 1, l, 16, 64)
    q3 = (q.float() * 3.0).to(torch.bfloat16)
    scale = attention._full_scale(64, torch.bfloat16)
    out = attention.flash_full_mha(q3, k, v).float()
    prescale = {
        "helper_bit_exact": torch.equal(
            attention._full_prescaled_q(q3),
            (q3.float() * scale).to(torch.bfloat16)),
        "mean_err_to_bf16_scale_twin": float((out - full_twin_on(
            torch, attention._full_prescaled_q(q3), k, v)).abs().mean()),
        "mean_err_to_f32_scale_twin": float((out - full_twin_on(
            torch, attention._prescaled_q(q3, 64), k, v)).abs().mean())}
    del out, q3
    # P·V keeps P in f32 (the P_hi + P_lo split): the kernel's output sits
    # on the f32-P twin, not on one that rounds P to bf16 before P·V (the
    # packed kernel's product).  Both twins are rounded to bf16 as the
    # kernel's output is: unrounded, that last rounding is as large as
    # the bf16-P error and hides it.
    out = attention.flash_full_mha(q, k, v).float()
    qs = attention._full_prescaled_q(q)
    pv_precision = {
        f"mean_err_to_{name}_twin": float((out - full_twin_on(
            torch, qs, k, v, p_bf16=p_bf16).to(torch.bfloat16).float()
        ).abs().mean()) for name, p_bf16 in (("f32_p", False),
                                             ("bf16_p", True))}
    del out, qs
    try:
        log = _build.build_log("flash_full_fwd.cu")
    except FileNotFoundError:
        log = None
    build = ptxas_summary(log, "flash_full_kernel") if log else None
    serialised = re.findall(r"C75(?:15|19|20)", log or "")
    split = device_ms_by_kernel(torch, lambda: attention.flash_full_mha(
        q, k, v))
    qp, kp, vp = fused_heads(torch, dev, gen, 1, 1100, 5, 20)
    split_padded = device_ms_by_kernel(torch, lambda: attention
                                       .flash_full_mha(qp, kp, vp))
    del qp, kp, vp
    torch.cuda.synchronize()     # host time of the wrapper: 20 enqueues
    t0 = time.perf_counter()
    for _ in range(20):
        attention.flash_full_mha(q, k, v)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    ms = cuda_ms(lambda: attention.flash_full_mha(q, k, v), 20)
    plain_ms = cuda_ms(lambda: attention.flash_full_mha_ref(q, k, v), 3)
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v))), 20)
    packed_ms = cuda_ms(lambda: attention.flash_mha_packed(
        *(x.reshape(1, l, -1) for x in (q, k, v)), num_heads=16, l_real=l),
        20)
    l512 = 2 + N_VIEWS * (512 // 8) ** 2                    # 16386
    q5, k5, v5 = fused_heads(torch, dev, gen, 1, l512, 16, 64)
    ms_512 = cuda_ms(lambda: attention.flash_full_mha(q5, k5, v5), 10)
    del q5, k5, v5
    bound_512 = attn_fwd_bound(1, l512, l512, 16, 64, pv="tf32")
    # per query-key pair and head: the function's two products (4 d flop)
    # and the three bf16 products the split kernel runs on the tensor
    # cores (6 d), both over real rows and keys (tile padding not counted)
    rates = {f"{what}_tflops{at}": n * 16 * 64 * ll * ll / (t * 1e-3) / 1e12
             for what, n in (("function", 4.0), ("tensor_core", 6.0))
             for at, ll, t in (("", l, ms), ("_L16386", l512, ms_512))}
    res = {"cases": cases, "ms": ms, "plain_ms": plain_ms,
           "sdpa_ms": sdpa_ms, **attn_fwd_bound(1, l, l, 16, 64, pv="tf32"),
           "packed_kernel_ms_same_inputs": packed_ms, "ms_L16386": ms_512,
           "bound_ms_L16386": bound_512["bound_ms"], **rates,
           "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
           "prescale": prescale, "pv_precision": pv_precision,
           "ptxas": build,
           "ptxas_serialisation_warnings": len(serialised),
           "device_ms_by_kernel": split, "wrapper_host_us": host_us,
           "device_ms_by_kernel_padded_1x1100x5x20": split_padded,
           "timed": f"b=1 L={l} (and {l512}) h=16 d=64 bf16, fused qkv; "
                    f"plain twin at L={l} only"}
    print(f"[9a general attention kernel] {json.dumps(res)}", flush=True)
    for name, c in cases.items():
        if not c["rel_max_err"] <= ATTN_REL_BOUND:
            raise AssertionError(f"flash_full_mha {name}: rel-max error "
                                 f"{c['rel_max_err']:.3g} > {ATTN_REL_BOUND}")
    if not prescale["helper_bit_exact"]:
        raise AssertionError("#5's q~ helper differs from bf16(f32(q) * "
                             "f32(bf16 scale)) on the card")
    if not (prescale["mean_err_to_bf16_scale_twin"]
            < 0.5 * prescale["mean_err_to_f32_scale_twin"]):
        raise AssertionError(f"flash_full_mha does not round q~ as #5: "
                             f"{prescale}")
    if not (pv_precision["mean_err_to_f32_p_twin"]
            < 0.5 * pv_precision["mean_err_to_bf16_p_twin"]):
        raise AssertionError(f"flash_full_mha's P·V is not f32-precise: "
                             f"{pv_precision}")
    if not build:
        raise AssertionError(
            "the build holds no flash_full_fwd.log" if log is None else
            "flash_full_fwd.log reports no flash_full_kernel")
    if serialised:
        raise AssertionError(f"ptxas serialised wgmma in flash_full_fwd.cu "
                             f"({len(serialised)} warnings C7515/C7519/"
                             f"C7520)")
    return res


def phase_smax(torch, dev) -> dict:
    """9b: the scalar-max packed forward vs its twin (64-row blocks)."""
    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(5)
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    err, rel, (q, k, v), kw = attention_case(torch, dev, gen, 1, l, l, 16,
                                             64, fused=True, scalar_max=True)
    err_r, rel_r, _, _ = attention_case(torch, dev, gen, 1, l, 4608, 16, 64,
                                        fused=True, scalar_max=True)
    ms = cuda_ms(lambda: attention.flash_mha_packed(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: attention.flash_mha_packed_ref(q, k, v, **kw),
                       3)
    row_ms = cuda_ms(lambda: attention.flash_mha_packed(
        q, k, v, num_heads=16, l_real=l), 20)
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *(x.reshape(1, l, 16, 64).transpose(1, 2) for x in (q, k, v))), 20)
    res = {"max_abs_err": max(err, err_r), "rel_max_err": rel,
           "ragged_rel_max_err": rel_r, "ms": ms, "plain_ms": plain_ms,
           "row_max_kernel_ms": row_ms, "sdpa_ms": sdpa_ms,
           **attn_fwd_bound(1, l, l, 16, 64),
           "shape": f"b=1 L={l} h=16 dh=64 bf16, fused qkv"}
    print(f"[9b scalar-max forward] {json.dumps(res)}", flush=True)
    for name, r in (("L=4098", rel), ("ragged Lp=4608", rel_r)):
        if not r <= ATTN_REL_BOUND:
            raise AssertionError(f"scalar-max kernel {name}: rel-max error "
                                 f"{r:.3g} > {ATTN_REL_BOUND}")
    return res


def phase_general_sampling(torch, dev) -> dict:
    """9c: the sampling entry point with 16 heads of 48 (general route)."""
    import numpy as np

    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    # 12 of the config's 24 layers: the smoke's time goes to phases 13-14
    system = build_system(torch, dev, overrides=(
        "system.shape_model.width=768", "system.shape_model.dim_heads=48",
        f"system.shape_model.num_layers={GENERAL_SAMPLING_LAYERS}"))
    blocks = system.model.transformer
    if any(blk.attn.packed for blk in blocks):
        raise AssertionError("16 heads of 48 must take the general route")
    pipe = DiffusionGSPipeline(system)
    kw = dict(resolution=RES, n_views=N_VIEWS, matting="border")
    pipe.batch([IMAGE], **kw)                       # warm-up run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(attention, blend_kernel)
    t0 = time.perf_counter()
    out = pipe.batch([IMAGE], **kw)[0]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts(attention)
    blend_launches = blend_kernel.LAUNCHES
    want = dict({n: 0 for n in launches},
                LAUNCHES_FULL=len(blocks) * STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    # the device's share of an asset, free of the host's spread: kernel
    # time summed over one more asset (one stream: the sum is busy time)
    by_kernel = device_ms_by_kernel(torch, lambda: pipe.batch([IMAGE], **kw),
                                    iters=1, warm_up=False)
    g = out.gaussians
    res = {"seconds_per_asset": secs,
           "device_ms_per_asset": sum(by_kernel.values()),
           "general_kernel_device_ms_per_asset": kernel_ms(
               by_kernel, "flash_full_kernel"),
           "max_memory_allocated_bytes": peak,
           "launches": launches, "expected_launches": want,
           "blend_launches": blend_launches,
           "gaussians_after_filters": int(g.xyz.shape[0]),
           "renders_shape": list(out.renders.shape),
           "config": "configs/diffusionGS_rel.yaml with width 768, "
                     "dim_heads 48 (16 heads, L = 4098) and 12 of its 24 "
                     "layers; no "
                     "shipped config uses this layout",
           "card": card_line()}
    print(f"[9c general-route sampling] {json.dumps(res)}", flush=True)
    if launches != want:
        raise AssertionError(f"attention launches {launches} != {want}")
    if list(out.renders.shape) != [N_VIEWS, 3, RES, RES]:
        raise AssertionError(f"renders shape {out.renders.shape}")
    if not np.isfinite(out.renders).all():
        raise AssertionError("non-finite renders")
    if not all(np.isfinite(x).all() for x in g):
        raise AssertionError("non-finite Gaussians")
    return res


def phase_qk_norm_stack(torch, dev) -> dict:
    """9d: 24 qk_norm DiT blocks at the flagship width (the reference's
    DiTBlock_QK_Norm), forward under no_grad."""
    from open_diffusiongs_tpu_torch.models.transformer import DiTBlock
    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(0)
    width, heads, layers = 1024, 16, 24
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    blocks = torch.nn.ModuleList(
        DiTBlock(width, heads, dtype=torch.bfloat16, qk_norm=True)
        for _ in range(layers)).to(dev)
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn((1, l, width), generator=gen, device=dev)
    c = torch.randn((1, width), generator=gen, device=dev)

    def forward():
        h = x
        for blk in blocks:
            h = blk(h, c)
        return h

    with torch.no_grad():
        forward()                                   # warm-up
        torch.cuda.synchronize()
        reset_launches(attention)
        t0 = time.perf_counter()
        y = forward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = launch_counts(attention)
    want = dict({n: 0 for n in launches}, LAUNCHES_FULL=layers)
    res = {"seconds": secs, "launches": launches, "expected_launches": want,
           "finite": bool(torch.isfinite(y).all()),
           "out_abs_max": float(y.abs().max()),
           "shape": f"{layers} x DiTBlock({width}, {heads}, qk_norm=True), "
                    f"b=1 L={l} bf16",
           "card": card_line()}
    print(f"[9d qk-norm stack] {json.dumps(res)}", flush=True)
    if launches != want:
        raise AssertionError(f"attention launches {launches} != {want}")
    if not res["finite"]:
        raise AssertionError("qk-norm stack: non-finite output")
    return res


def phase_bench_variants(torch, dev) -> dict:
    """9e: the bench entry point: --check of every variant, then one timed
    sweep at L = 4098 whose launches are counted."""
    from open_diffusiongs_tpu_torch.ops import attention
    from open_diffusiongs_tpu_torch.tools import bench_attn
    check = bench_attn.check(dev)
    torch.cuda.synchronize()
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    iters = 10
    reset_launches(attention)
    sweep = bench_attn.sweep(dev, l, 16, iters)
    launches = launch_counts(attention)
    gen = torch.Generator(device=dev).manual_seed(6)
    qs, k, v, _ = bench_attn._qkv(gen, dev, 16, l, l)
    plain_ms = cuda_ms(lambda: attention.mha_full_ref(qs, k, v, l_real=l), 3)
    # q is pre-scaled for the base-2 softmax; SDPA at scale 1 does the same
    # products on the same inputs
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs[None], k[None], v[None], scale=1.0), 20)
    res = {"check": check, "sweep": sweep, "launches": launches,
           "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
           **attn_fwd_bound(1, l, l, 16, 64),
           "shape": f"h=16 L={l} d=64 bf16 (check: L=700 padded to 1024)"}
    print(f"[9e bench variants] {json.dumps(res)}", flush=True)
    for name, (pv_f32, score_bf16) in bench_attn.VARIANTS.items():
        r = check[name]
        if score_bf16 and not r["max_abs_err"] <= bench_attn.CHECK_BAR:
            raise AssertionError(f"{name}: max abs error "
                                 f"{r['max_abs_err']:.3g} > "
                                 f"{bench_attn.CHECK_BAR}")
        if not score_bf16 and not r["rel_max_err"] <= ATTN_REL_BOUND:
            raise AssertionError(f"{name}: rel-max error "
                                 f"{r['rel_max_err']:.3g} > {ATTN_REL_BOUND}")
    if not check[bench_attn.SMAX]["rel_max_err"] <= ATTN_REL_BOUND:
        raise AssertionError(f"scalar-max check: {check[bench_attn.SMAX]}")
    each = iters + 2                                # timed + warm-up
    if (launches["LAUNCHES_MHA_FULL"] != len(bench_attn.VARIANTS) * each
            or launches["LAUNCHES_SMAX"] != each):
        raise AssertionError(f"bench launches {launches}")
    return res


def phase_dh16(torch, dev) -> dict:
    """9f: the packed kernels at dh = 16 (the packed layout of 64 heads at
    width 1024), forward, forward with lse and backward."""
    gen = torch.Generator(device=dev).manual_seed(8)
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    kw = dict(h=16, dh=16, b=2, plain_fwd=True)
    full, _ = attention_train_case(torch, dev, gen, l, l, **kw)
    ragged, _ = attention_train_case(torch, dev, gen, l, 4608, **kw)
    torch.cuda.empty_cache()
    res = {"full": full, "ragged_lp4608": ragged,
           "shape": f"b=2 L={l} h=16 dh=16 bf16, fused qkv"}
    print(f"[9f packed dh=16] {json.dumps(res)}", flush=True)
    for case, r in (("L=4098", full), ("ragged Lp=4608", ragged)):
        checks = [("o rel-max", r["o_rel_max"], ATTN_REL_BOUND),
                  ("o (no stats) rel-max", r["o_plain_rel_max"],
                   ATTN_REL_BOUND),
                  ("lse max abs", r["lse_max_abs"], LSE_ABS_BOUND)]
        checks += [(f"{n} rel-max", r[f"{n}_rel_max"], GRAD_REL_BOUND)
                   for n in ("dq", "dk", "dv")]
        for name, val, bound in checks:
            if not val <= bound:
                raise AssertionError(f"dh=16 {case}: {name} {val:.3g} > "
                                     f"{bound}")
        for n in ("lse", "dq", "dk", "dv"):
            if not r[f"{n}_pad_zero"]:
                raise AssertionError(f"dh=16 {case}: {n} pad rows are not "
                                     f"exactly 0")
    return res


# 9g: (b, l_real, Lp, heads, dh) off the main path's tiling: fewer keys than
# one tile, ragged last tiles, a 64-row q tile past Lp, dh 32
ODD_SHAPES = ((1, 300, 300, 2, 64), (2, 1000, 1090, 4, 32),
              (1, 70, 130, 3, 64), (2, 200, 333, 2, 16), (1, 129, 260, 2, 64))


def phase_odd_shapes(torch, dev) -> dict:
    """9g: the packed kernels (forward with and without lse, scalar max,
    backward) at ODD_SHAPES, phase 6's bounds."""
    gen = torch.Generator(device=dev).manual_seed(9)
    res = {}
    for b, l, lp, h, dh in ODD_SHAPES:
        name = f"b={b} L={l} Lp={lp} h={h} dh={dh}"
        r, _ = attention_train_case(torch, dev, gen, l, lp, h=h, dh=dh, b=b,
                                    plain_fwd=True)
        _, r["smax_rel_max"], _, _ = attention_case(
            torch, dev, gen, b, l, lp, h, dh, fused=True, scalar_max=True)
        res[name] = r
        checks = [(n, r[n], ATTN_REL_BOUND)
                  for n in ("o_rel_max", "o_plain_rel_max", "smax_rel_max")]
        checks += [("lse_max_abs", r["lse_max_abs"], LSE_ABS_BOUND)]
        checks += [(f"{n}_rel_max", r[f"{n}_rel_max"], GRAD_REL_BOUND)
                   for n in ("dq", "dk", "dv")]
        for what, val, bound in checks:
            if not val <= bound:
                raise AssertionError(f"packed kernels {name}: {what} "
                                     f"{val:.3g} > {bound}")
        for n in ("lse", "dq", "dk", "dv"):
            if not r[f"{n}_pad_zero"]:
                raise AssertionError(f"packed kernels {name}: {n} pad rows "
                                     f"are not exactly 0")
    print(f"[9g packed odd shapes] {json.dumps(res)}", flush=True)
    return res


# phase 16: training through the general attention route
# 16a: (b, l, h, d, q0, q1, lk, contiguous q/k): queries q0:q1 over keys
# :lk of a fused qkv [b, l, 3 h d], each batch element at its own scale:
# the train path's batch at 16 heads of 64 and of 48 (column slices, and
# contiguous q / k as the qk_norm blocks' RMSNorm hands them), d 40 and
# 20 (the padded copies), both halves of subset attention (3072 queries
# over 4098 keys, 1026 over 1026), and shapes off the kernels' tiling (one
# query over 3 keys: over one key dq and dk are 0 and a relative error has
# no scale)
GENERAL_TRAIN_CASES = (
    (4, 4098, 16, 64, 0, 4098, 4098, False),
    (4, 4098, 16, 48, 0, 4098, 4098, False),
    (4, 4098, 16, 64, 0, 4098, 4098, True),
    (2, 700, 3, 40, 0, 700, 700, False),
    (2, 1100, 5, 20, 0, 1100, 1100, False),
    (4, 4098, 16, 64, 1026, 4098, 4098, False),
    (4, 4098, 16, 64, 0, 1026, 1026, False),
    (1, 70, 3, 64, 0, 70, 70, False), (2, 129, 2, 32, 0, 129, 129, True),
    (1, 300, 2, 64, 298, 300, 300, False), (1, 3, 2, 64, 0, 1, 3, False),
    (3, 200, 2, 8, 0, 200, 200, False))


def full_twin_by_head(torch, twin, h, *tensors):
    """A general-route twin run one head at a time on [b, l, h, d] inputs
    (and an lse [b, h, l]), its outputs joined again: one head's f32 score
    matrices alive at a time."""
    parts = []
    for i in range(h):
        out = twin(*(x[:, :, i:i + 1] if x.dim() == 4 else x[:, i:i + 1]
                     for x in tensors))
        parts.append(out if isinstance(out, tuple) else (out,))
    return tuple(torch.cat(p, 2 if p[0].dim() == 4 else 1)
                 for p in zip(*parts))


def general_train_case(torch, dev, gen, b, n, h, d, q0, q1, lk,
                       contiguous: bool):
    """#5s and #5b against their twins (run head by head) on bf16 inputs;
    errors relative per batch element."""
    from open_diffusiongs_tpu_torch.ops import attention
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev)
    qkv *= torch.tensor(QKV_SCALES[:b], device=dev)[:, None, None]
    q, k, v = (x.reshape(b, n, h, d)
               for x in qkv.to(torch.bfloat16).chunk(3, dim=-1))
    if contiguous:
        q, k = q.contiguous(), k.contiguous()
    q, k, v = q[:, q0:q1], k[:, :lk], v[:, :lk]
    do = torch.randn((b, q1 - q0, h, d), generator=gen, device=dev)
    do *= torch.tensor(DO_SCALES[:b], device=dev)[:, None, None, None]
    do = do.to(torch.bfloat16)
    o, lse = attention.flash_full_mha_stats(q, k, v)
    o_r, lse_r = full_twin_by_head(torch, attention.flash_full_mha_stats_ref,
                                   h, q, k, v)
    grads = attention.flash_full_mha_bwd(q, k, v, o, do, lse)
    refs = full_twin_by_head(torch, attention.flash_full_mha_bwd_ref, h,
                             q, k, v, o, do, lse)
    torch.cuda.synchronize()

    def rel(out, ref):          # the worst batch element
        return max(rel_max(out[i], ref[i]) for i in range(b))

    res = {"o_rel_max": rel(o, o_r),
           "o_max_abs": float((o.float() - o_r.float()).abs().max()),
           "lse_max_abs": float((lse - lse_r).abs().max()),
           "tma_reads_views": all(attention.full_takes_view(
               x.data_ptr(), x.shape, x.stride(), x.element_size())
               for x in (q, k, v))}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not torch.isfinite(g).all():
            raise AssertionError(f"#5b: non-finite {name}")
        res[f"{name}_rel_max"] = rel(g, r)
        res[f"{name}_max_abs"] = float((g.float() - r.float()).abs().max())
    if not torch.isfinite(o).all():
        raise AssertionError("#5s: non-finite o")
    return res, (q, k, v, o, do, lse)


def general_train_timing(torch, q, k, v, o, do, lse) -> dict:
    """#5s and #5b by CUDA events beside their twins, SDPA's forward on the
    same inputs, SDPA's backward alone (autograd.grad over a retained
    graph) and their bounds; the backward's device ms by kernel."""
    import torch.nn.functional as F

    from open_diffusiongs_tpu_torch.ops import attention
    b, l, h, d = q.shape
    res = {"fwd_ms": cuda_ms(lambda: attention.flash_full_mha_stats(q, k, v),
                             20),
           "bwd_ms": cuda_ms(lambda: attention.flash_full_mha_bwd(
               q, k, v, o, do, lse), 20),
           "fwd_plain_ms": cuda_ms(lambda: full_twin_by_head(
               torch, attention.flash_full_mha_stats_ref, h, q, k, v), 1),
           "bwd_plain_ms": cuda_ms(lambda: full_twin_by_head(
               torch, attention.flash_full_mha_bwd_ref, h, q, k, v, o, do,
               lse), 1),
           "bwd_kernels_ms": device_ms_by_kernel(
               torch, lambda: attention.flash_full_mha_bwd(q, k, v, o, do,
                                                           lse)),
           "fwd_bound": attn_fwd_bound(b, l, l, h, d, stats=True,
                                       pv="tf32"),
           "bwd_bound": attn_bwd_bound(b, l, l, h, d)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    with torch.no_grad():
        res["sdpa_fwd_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
    out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    res["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    return res


def phase_general_train_kernels(torch, dev) -> dict:
    """16a: #5s and #5b against their twins at GENERAL_TRAIN_CASES; q~'s
    rounding; determinism; the build; times at b = 4, L = 4098."""
    from open_diffusiongs_tpu_torch.ops import _build, attention
    gen = torch.Generator(device=dev).manual_seed(16)
    cases, timed = {}, {}
    for b, n, h, d, q0, q1, lk, contiguous in GENERAL_TRAIN_CASES:
        name = f"{b}x{n}x{h}x{d}"
        if (q0, q1, lk) != (0, n, n):
            name += f" queries {q0}:{q1} over {lk} keys"
        if contiguous:
            name += " contiguous q/k"
        cases[name], inputs = general_train_case(torch, dev, gen, b, n, h, d,
                                                 q0, q1, lk, contiguous)
        if (b, n, q0, lk, contiguous) == (TRAIN_BATCH, 4098, 0, 4098,
                                           False):
            timed[f"h{h}_d{d}"] = inputs
        del inputs
    q, k, v, o, do, lse = timed["h16_d64"]
    # Determinism: two launches of the backward on the same inputs agree
    # bit for bit (every output written once, sums in a fixed order).
    g1 = attention.flash_full_mha_bwd(q, k, v, o, do, lse)
    g2 = attention.flash_full_mha_bwd(q, k, v, o, do, lse)
    bit_identical = all(torch.equal(x, y) for x, y in zip(g1, g2))
    del g1, g2
    with open(os.path.join(ROOT, "open_diffusiongs_tpu_torch", "csrc",
                           "flash_full_bwd.cu")) as f:
        atomic_free = "atomic" not in f.read().lower()
    # q~ = bf16(q * bf16(d^-1/2)), the training function's (not #5's
    # bf16(d^-1/2 log2 e)): the helper bit for bit on the card, and at 3x
    # scores the kernel's o sits on the training twin, not on #5's.
    q3 = (q.float() * 3.0).to(torch.bfloat16)
    o3 = attention.flash_full_mha_stats(q3, k, v)[0].float()
    prescale = {
        "helper_bit_exact": all(torch.equal(
            attention._train_prescaled_q(x),
            (x.float() * attention._train_scale(x.shape[-1], x.dtype))
            .to(torch.bfloat16)) for x in (q, timed["h16_d48"][0])),
        "mean_err_to_train_twin": float((o3 - full_twin_by_head(
            torch, attention.flash_full_mha_stats_ref, 16, q3, k, v)[0]
            .float()).abs().mean()),
        "mean_err_to_serving_twin": float((o3 - full_twin_by_head(
            torch, attention.flash_full_mha_ref, 16, q3, k, v)[0]
            .float()).abs().mean())}
    del q3, o3
    builds, warnings = {}, 0
    for src, entry in (("flash_full_fwd.cu", "flash_full_kernel"),
                       ("flash_full_bwd.cu", "flash_full_bwd")):
        try:
            log = _build.build_log(src)
        except FileNotFoundError:
            raise AssertionError(f"the build holds no report of {src}")
        builds.update({f"{src} {k}": v
                       for k, v in ptxas_summary(log, entry).items()
                       if src != "flash_full_fwd.cu" or "stats=1" in k})
        warnings += len(re.findall(r"C75(?:15|19|20)", log))
    times = {key: general_train_timing(torch, *inputs)
             for key, inputs in timed.items()}
    del timed, q, k, v, o, do, lse
    torch.cuda.empty_cache()
    res = {"cases": cases, "times": times,
           "bwd_bit_identical": bit_identical,
           "bwd_source_atomic_free": atomic_free, "prescale": prescale,
           "ptxas": builds, "ptxas_serialisation_warnings": warnings,
           "max_abs_err_fwd": max(max(c["o_max_abs"], c["lse_max_abs"])
                                  for c in cases.values()),
           "max_abs_err_bwd": max(c[f"{n}_max_abs"] for c in cases.values()
                                  for n in ("dq", "dk", "dv")),
           "timed": f"b={TRAIN_BATCH} L=4098 h=16, d 64 and 48, bf16 column "
                    f"slices of a fused qkv",
           "card": card_line()}
    print(f"[16a general-route training kernels] {json.dumps(res)}",
          flush=True)
    for name, c in cases.items():
        checks = [("o rel-max", c["o_rel_max"], ATTN_REL_BOUND),
                  ("lse max abs", c["lse_max_abs"], LSE_ABS_BOUND)]
        checks += [(f"{n} rel-max", c[f"{n}_rel_max"], GRAD_REL_BOUND)
                   for n in ("dq", "dk", "dv")]
        for what, val, bound in checks:
            if not val <= bound:
                raise AssertionError(f"general-route training {name}: "
                                     f"{what} {val:.3g} > {bound}")
    if not bit_identical:
        raise AssertionError("#5b: dq/dk/dv differ between two launches on "
                             "the same inputs")
    if not atomic_free:
        raise AssertionError("csrc/flash_full_bwd.cu uses atomics")
    if not prescale["helper_bit_exact"]:
        raise AssertionError("the training q~ differs from bf16(q * "
                             "bf16(d^-1/2)) on the card")
    if not (prescale["mean_err_to_train_twin"]
            < 0.5 * prescale["mean_err_to_serving_twin"]):
        raise AssertionError(f"#5s does not compute the training function: "
                             f"{prescale}")
    if len(builds) != 3 + 6:    # 3 STATS tiles; dQ and dK/dV at 3 tiles
        raise AssertionError(f"ptxas reports {sorted(builds)}")
    spills = {k: v for k, v in builds.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills or warnings:
        raise AssertionError(f"ptxas: spills {spills}, {warnings} wgmma "
                             f"serialisation warnings")
    return res


def phase_qk_norm_train(torch, dev) -> dict:
    """16b: 24 DiTBlock(1024, 16, qk_norm=True), forward and backward at
    the train path's b = 4, L = 4098, bf16 (no block checkpointing)."""
    from open_diffusiongs_tpu_torch.models.transformer import DiTBlock
    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(0)
    width, heads, layers = 1024, 16, 24
    l = 2 + N_VIEWS * (RES // 8) ** 2                       # 4098
    blocks = torch.nn.ModuleList(
        DiTBlock(width, heads, dtype=torch.bfloat16, qk_norm=True)
        for _ in range(layers)).to(dev)
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn((TRAIN_BATCH, l, width), generator=gen, device=dev)
    c = torch.randn((TRAIN_BATCH, width), generator=gen, device=dev)
    params = list(blocks.parameters())

    def step():
        h = x
        for blk in blocks:
            h = blk(h, c)
        return torch.autograd.grad(h.float().square().mean(), params)

    step()                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(attention)
    t0 = time.perf_counter()
    grads = step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts(attention)
    want = dict({n: 0 for n in launches}, LAUNCHES_FULL_STATS=layers,
                LAUNCHES_FULL_BWD=layers)
    res = {"seconds": secs, "launches": launches, "expected_launches": want,
           "finite_grads": all(bool(torch.isfinite(g).all()) for g in grads),
           "min_qkv_grad_norm": min(float(g.norm()) for (n, _), g in zip(
               blocks.named_parameters(), grads) if n.endswith("qkv.weight")),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "shape": f"{layers} x DiTBlock({width}, {heads}, qk_norm=True), "
                    f"b={TRAIN_BATCH} L={l} bf16, forward + backward",
           "card": card_line()}
    print(f"[16b qk-norm stack training] {json.dumps(res)}", flush=True)
    if launches != want:
        raise AssertionError(f"attention launches {launches} != {want}")
    if not res["finite_grads"] or not res["min_qkv_grad_norm"] > 0:
        raise AssertionError("qk-norm stack: non-finite or zero gradients")
    return res


def phase_general_train(torch, dev) -> dict:
    """16c: phase 8's train step with 16 heads of 48 (width 768), all 24
    layers: the general route's training kernels in the step."""
    return phase_train(torch, dev, label="16c general-route train step",
                       overrides=("system.shape_model.width=768",
                                  "system.shape_model.dim_heads=48"))


# phases 13-14: the training / evaluation CLI on synthetic trees
CONFIG_SCENE_EVAL = os.path.join(ROOT, "configs",
                                 "diffusionGS_scene_eval.yaml")
OBJECTS, OBJECT_VIEWS, OBJECT_RES = 4, 40, 512   # G-Objaverse renders
SCENES, SCENE_FRAMES, RE10K_HW = 16, 8, (360, 640)
LAUNCH_STEPS, RESUME_STEPS = 4, 6
EVAL_PASSES = 4             # launch.EVAL_SEEDS: train_loss passes per eval
LOADER_BATCHES = 8
PATH_STEPS = 10             # eval_utils steps_per_transition
# a parameter, whose EMA and Adam first moment are checked after a restore
RESTORE_CHECK = "transformer.0.attn.qkv.weight"


def smooth_shape(res_h: int, res_w: int, phase: float, seed: int):
    """An RGB gradient inside an ellipse that turns with `phase`, alpha 1
    inside and 0 outside, and a depth field over it: renders-like content
    that PNG and zip-EXR compress as real renders do (not noise)."""
    import numpy as np
    y, x = np.mgrid[0:res_h, 0:res_w].astype(np.float32)
    u, v = x / res_w - 0.5, y / res_h - 0.5
    c, s_ = np.cos(phase), np.sin(phase)
    a, b = 0.30 + 0.05 * (seed % 3), 0.18 + 0.04 * c
    inside = ((u * c + v * s_) / a) ** 2 + ((v * c - u * s_) / b) ** 2 < 1.0
    rgb = np.stack([0.5 + 0.5 * np.sin(6.0 * u + phase + seed),
                    0.5 + 0.4 * np.cos(5.0 * v - phase),
                    0.3 + 0.6 * (u + 0.5) * (v + 0.5)], axis=-1)
    depth = np.where(inside, 2.2 - 0.6 * np.sqrt(np.maximum(
        1.0 - (u / a) ** 2 - (v / b) ** 2, 0.0)), 0.0).astype(np.float32)
    return rgb, inside, depth


def write_gobjaverse_tree(root: str, n_objects: int, n_views: int,
                          res: int) -> tuple:
    """A G-Objaverse tree in the layout of tests/synthetic_fixtures.py
    (campos_512_v4/{idx:05d}/{idx:05d}.png + .json + _nd.exr; train.json
    and test.json), written with the port's utils/exr.py (zip blocks, as
    the real `_nd.exr` files) and PIL, on 8 threads.  Returns (data dir,
    image dir, bytes)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from open_diffusiongs_tpu_torch.utils.exr import write_exr
    data, images = os.path.join(root, "data"), os.path.join(root, "images")
    os.makedirs(data)
    uids = [f"000/obj{i}" for i in range(n_objects)]
    for split in ("train", "test"):
        with open(os.path.join(data, f"{split}.json"), "w") as f:
            json.dump(uids, f)

    def view(args):
        oi, idx = args
        d = os.path.join(images, uids[oi], "campos_512_v4", f"{idx:05d}")
        os.makedirs(d)
        prefix = os.path.join(d, f"{idx:05d}")
        ang = 2 * np.pi * idx / n_views
        rgb, inside, depth = smooth_shape(res, res, ang, oi)
        rgba = np.concatenate([rgb, inside[..., None]], axis=-1)
        Image.fromarray((rgba * 255.0 + 0.5).astype(np.uint8),
                        "RGBA").save(prefix + ".png")
        origin = np.asarray([2.2 * np.cos(ang), 2.2 * np.sin(ang), 0.9])
        z = -origin / np.linalg.norm(origin)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        with open(prefix + ".json", "w") as f:
            json.dump({"x": x.tolist(), "y": y.tolist(), "z": z.tolist(),
                       "origin": origin.tolist()}, f)
        nd = np.zeros((res, res, 4), np.float32)
        nd[..., :3] = rgb * 2.0 - 1.0              # normal-like channels
        nd[..., 3] = depth
        write_exr(prefix + "_nd.exr", nd, ["R", "G", "B", "A"],
                  compression="zip")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(view, [(o, i) for o in range(n_objects)
                             for i in range(n_views)]))
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(images) for f in fs)
    return data, images, nbytes


def write_re10k_tree(root: str, n_scenes: int, n_frames: int,
                     hw: tuple) -> str:
    """An RE10K tree in the layout of tests/synthetic_fixtures.py (per
    scene a metadata json of frames: image_path, fxfycxcy in pixels, w2c;
    a full_list.txt), frames at the RE10K frame size: a camera moving
    forward with a slight turn.  Returns the full_list.txt path."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image
    h, w = hw
    paths = []

    def scene(si):
        sd = os.path.join(root, "images", f"scene{si:03d}")
        os.makedirs(sd)
        frames = []
        for i in range(n_frames):
            rgb, inside, _ = smooth_shape(h, w, 0.15 * i + si, si)
            rgb = np.where(inside[..., None], rgb, 0.6 + 0.3 * rgb[..., ::-1])
            p = os.path.join(sd, f"{i:05d}.png")
            Image.fromarray((rgb * 255.0 + 0.5).astype(np.uint8)).save(p)
            yaw = 0.03 * i
            w2c = np.eye(4)
            w2c[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                           [-np.sin(yaw), 0, np.cos(yaw)]]
            w2c[:3, 3] = [0.1 * np.cos(0.1 * i), 0.05 * np.sin(0.1 * i),
                          0.2 * i]
            frames.append({"image_path": p,
                           "fxfycxcy": [0.5 * w, 0.5 * w, w / 2.0, h / 2.0],
                           "w2c": w2c.tolist()})
        mp = os.path.join(root, "metadata", f"scene{si:03d}.json")
        with open(mp, "w") as f:
            json.dump({"scene_name": f"scene{si:03d}", "frames": frames}, f)
        return mp

    os.makedirs(os.path.join(root, "metadata"))
    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(scene, range(n_scenes)))
    full_list = os.path.join(root, "full_list.txt")
    with open(full_list, "w") as f:
        f.write("\n".join(paths) + "\n")
    return full_list


def read_csv(path: str) -> list:
    import csv
    with open(path) as f:
        return [r for r in csv.reader(f) if r]


def launch_call(torch, dev, argv: list, modules) -> tuple:
    """launch.main(argv) in process: its record, the kernels' launch counts
    of the call (set to 0 just before it, read just after), its host
    seconds and collector seconds, and the peak device memory."""
    from open_diffusiongs_tpu_torch import launch
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(*modules)
    with GcClock() as gc_clock:
        t0 = time.perf_counter()
        record = launch.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = {f"{m.__name__.rsplit('.', 1)[1]}.{n}": v for m in modules
              for n, v in launch_counts(m).items()}
    return record, counts, {"seconds": secs, "gc_seconds": gc_clock.seconds,
                            "stages": dict(record["seconds"]),
                            "max_memory_allocated_bytes":
                                torch.cuda.max_memory_allocated(dev)}


def drop_record(torch, record: dict) -> None:
    """Free a launch record's system and state on the card."""
    record.clear()
    collect_garbage()
    torch.cuda.empty_cache()


def expected_counts(steps=0, evals=0, sample_views=(), path_frames=0,
                    n_layers=24, views=0, samples=0) -> dict:
    """Launch counts derived from the config: per training step every DiT
    layer runs the forward with lse twice (block checkpointing) and the
    backward once, and the render blends and back-propagates each of the
    `views` (b x views per object) supervision views; each eval pass runs
    train_loss's forward once without grad; each sampled batch of
    `samples` scenes runs
    STEPS x n_layers attention launches and blends (STEPS - 1) x noisy +
    all views per scene; a path video renders `path_frames` views."""
    blend_sample = samples * sum((STEPS - 1) * (v - 1) + v
                                 for v in sample_views)
    return {
        "attention.LAUNCHES": (evals * EVAL_PASSES * n_layers
                               + len(sample_views) * STEPS * n_layers),
        "attention.LAUNCHES_STATS": steps * n_layers * 2,
        "attention.LAUNCHES_BWD": steps * n_layers,
        "attention.LAUNCHES_SMAX": 0, "attention.LAUNCHES_FULL": 0,
        "attention.LAUNCHES_MHA_FULL": 0,
        "attention.LAUNCHES_FULL_STATS": 0, "attention.LAUNCHES_FULL_BWD": 0,
        "blend_kernel.LAUNCHES": (steps + evals * EVAL_PASSES) * views
        + blend_sample + path_frames,
        "blend_kernel.LAUNCHES_BWD": steps * views,
    }


def phase_launch_train(torch, dev, tmp: str) -> dict:
    """13: object training through `launch` on a synthetic G-Objaverse
    tree: --train --max_steps 4, a resume to 6, then --export from that
    checkpoint (module docstring)."""
    import statistics

    import numpy as np

    from open_diffusiongs_tpu_torch.data.loader import PrefetchLoader
    from open_diffusiongs_tpu_torch.data.objaverse import ObjaverseDataset
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.utils.config import load_config
    mods = (attention, blend_kernel)
    t0 = time.perf_counter()
    data, images, tree_bytes = write_gobjaverse_tree(
        tmp, OBJECTS, OBJECT_VIEWS, OBJECT_RES)
    tree_s = time.perf_counter() - t0
    # paths, plus: no LPIPS weights ship (system.use_lpips=false); one
    # trial dir across the runs (use_timestamp=false); an eval at the
    # save's step; only the forced final saves; a log line every step of
    # the first run, for its per-step times
    overrides = [f"exp_root_dir={tmp}/outputs", f"data.local_dir={data}",
                 f"data.image_dir={images}/", "use_timestamp=false",
                 "system.use_lpips=false",
                 f"trainer.eval_every_n_steps={LAUNCH_STEPS}",
                 "checkpoint.every_n_train_steps=1000000"]
    cfg = load_config(CONFIG, cli_args=overrides, makedirs=False)
    b = int(cfg.data["batch_size"])
    views = int(cfg.data["gen_views"]) + int(cfg.data["sel_views"])
    base = ["--config", CONFIG, "--device", "cuda"]

    # the loader alone: 8 batches of the config's b and num_workers
    dataset = ObjaverseDataset(cfg.data, split="train", seed=cfg.seed)
    loader = PrefetchLoader(dataset, b, shuffle=True, seed=cfg.seed,
                            num_threads=int(cfg.data["num_workers"]))
    with GcClock() as gc_clock:
        t0 = time.perf_counter()
        stamps = []
        for i, _ in enumerate(loader):
            stamps.append(time.perf_counter() - t0)
            if i + 1 == LOADER_BATCHES:
                break
    loader_out = {"samples_per_second": LOADER_BATCHES * b / stamps[-1],
                  "samples_per_second_after_first": (LOADER_BATCHES - 1) * b
                  / (stamps[-1] - stamps[0]),
                  "batch_seconds": stamps, "gc_seconds": gc_clock.seconds}

    # phase 8's step in memory at the loader's 4 + 6 views: the baseline
    # of the step with the loader in the loop
    in_memory = phase_train(torch, dev, "13 in-memory step", CONFIG,
                            profile=False, sup_views=views)
    collect_garbage()
    torch.cuda.empty_cache()
    first, c1, w1 = launch_call(torch, dev, base + [
        "--train", "--max_steps", str(LAUNCH_STEPS), *overrides,
        "trainer.log_every_n_steps=1"], mods)
    trial = first["trial_dir"]
    save1 = first["saves"][-1]
    drop_record(torch, first)
    resumed, c2, w2 = launch_call(torch, dev, base + [
        "--train", "--max_steps", str(RESUME_STEPS), *overrides,
        f"resume={trial}/ckpts"], mods)
    state = resumed["state"]
    saved = {"param": state.params[RESTORE_CHECK],
             "ema": state.ema_params[RESTORE_CHECK],
             "adam_mu": state.optimizer.state_dict()["mu"][RESTORE_CHECK]}
    saved = {k: v.detach().cpu().clone() for k, v in saved.items()}
    save2, restore2 = resumed["saves"][-1], resumed["seconds"]["restore"]
    drop_record(torch, resumed)
    os.remove(os.path.join(trial, "ckpts", f"{LAUNCH_STEPS}.pt"))
    exported, c3, w3 = launch_call(torch, dev, base + [
        "--export", *overrides, f"resume={trial}/ckpts",
        "trainer.limit_val_batches=1"], mods)
    state = exported["state"]
    restored = {"param": state.params[RESTORE_CHECK],
                "ema": state.ema_params[RESTORE_CHECK],
                "adam_mu": state.optimizer.state_dict()["mu"][RESTORE_CHECK]}
    restored_equal = {k: bool(torch.equal(v.cpu(), saved[k]))
                      for k, v in restored.items()}
    export_dir, restore3 = exported["out_dir"], exported["seconds"]["restore"]
    export_seconds = exported["seconds"]
    drop_record(torch, exported)
    export_files = sorted(f for _, _, fs in os.walk(export_dir) for f in fs)

    rows = read_csv(os.path.join(trial, "metrics.csv"))
    head, data_rows = rows[0], rows[1:]
    col = {k: head.index(k) for k in head}
    steps = [int(r[0]) for r in data_rows]
    step_s = [1.0 / float(r[col["steps_per_sec"]]) for r in data_rows
              if int(r[0]) <= LAUNCH_STEPS]
    wait_s = [float(r[col["loader_wait_s"]]) for r in data_rows]
    evals = read_csv(os.path.join(trial, "eval_metrics.csv"))
    n_layers = 24
    want1 = expected_counts(steps=LAUNCH_STEPS, evals=2, views=b * views)
    want2 = expected_counts(steps=RESUME_STEPS - LAUNCH_STEPS, evals=1,
                            views=b * views)
    want3 = expected_counts(sample_views=(int(cfg.data["gen_views"]),),
                            samples=1, path_frames=(int(
                                cfg.data["gen_views"]) - 1) * PATH_STEPS + 1)
    med = statistics.median(step_s[1:])
    out = {"tree": {"objects": OBJECTS, "views": OBJECT_VIEWS,
                    "res": OBJECT_RES, "bytes": tree_bytes,
                    "write_s": tree_s},
           "loader_alone": loader_out,
           "step_seconds": step_s, "median_step_seconds_after_first": med,
           "loader_wait_seconds": wait_s,
           "in_memory_seconds_per_step": in_memory["seconds_per_step"],
           "samples_per_second": b / med,
           "note": f"step {LAUNCH_STEPS}'s time holds the eval at the save",
           "max_memory_allocated_bytes": w1["max_memory_allocated_bytes"],
           "checkpoint": {"bytes": save2["bytes"],
                          "save_seconds": [save1["seconds"],
                                           save2["seconds"]],
                          "restore_seconds": [restore2, restore3]},
           "overflow_frac": [float(r[col["overflow_frac"]])
                             for r in data_rows],
           "losses": [float(r[col["loss"]]) for r in data_rows],
           "metrics_steps": steps,
           "eval_rows": [r[0] for r in evals[1:]],
           "restored_equal": restored_equal,
           "launches": {"train": c1, "resume": c2, "export": c3},
           "expected_launches_per_step": {
               "attention_fwd_lse": 2 * n_layers, "attention_bwd": n_layers,
               "blend_fwd": b * views, "blend_bwd": b * views},
           "calls": {"train": w1, "resume": w2, "export": w3},
           "export": {"seconds": export_seconds, "files": export_files},
           "batch": f"b={b}, {views} views ({cfg.data['gen_views']} input) "
                    f"at {cfg.data['training_res'][0]}^2 from "
                    f"{OBJECT_RES}^2 renders",
           "overrides": overrides, "card": card_line()}
    print(f"[13 launch train] {json.dumps(out)}", flush=True)
    if steps != list(range(1, LAUNCH_STEPS + 2)):
        raise AssertionError(f"metrics.csv steps {steps}")
    if [r[0] for r in evals[1:]] != ["0", str(LAUNCH_STEPS),
                                     str(LAUNCH_STEPS)]:
        raise AssertionError(f"eval_metrics.csv steps {evals}")
    if evals[2] != evals[3]:
        raise AssertionError(f"the eval after the restore differs from the "
                             f"eval at the save: {evals[2]} != {evals[3]}")
    if not all(restored_equal.values()):
        raise AssertionError(f"restored state differs: {restored_equal}")
    if not all(np.isfinite(float(x)) for r in data_rows + evals[1:]
               for x in r[1:]):
        raise AssertionError("non-finite metrics")
    for got, want in ((c1, want1), (c2, want2), (c3, want3)):
        if got != want:
            raise AssertionError(f"launch kernel launches {got} != {want}")
    if not {".ply", ".png", ".avi"} <= {os.path.splitext(f)[1]
                                        for f in export_files}:
        raise AssertionError(f"export wrote {export_files}")
    out["launches_total"] = {k: c1[k] + c2[k] + c3[k] for k in c1}
    return out


def phase_scene_eval(torch, dev, tmp: str) -> dict:
    """14: scene eval through `launch --validate` at the config's
    eval_batch_size on a synthetic RE10K tree, then the metric CLI on its
    dumps (module docstring)."""
    import numpy as np

    from open_diffusiongs_tpu_torch import eval_scene_result
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    full_list = write_re10k_tree(tmp, SCENES, SCENE_FRAMES, RE10K_HW)
    tree_s = time.perf_counter() - t0
    # paths, and one batch of the eval set
    overrides = [f"exp_root_dir={tmp}/outputs",
                 f"data.local_dir={full_list}",
                 f"data.local_eval_dir={full_list}",
                 "trainer.limit_val_batches=1"]
    cfg = load_config(CONFIG_SCENE_EVAL, cli_args=overrides, makedirs=False)
    b = int(cfg.data["eval_batch_size"])
    n_in = int(cfg.data["sel_views"]) + 1
    record, counts, call = launch_call(
        torch, dev, ["--config", CONFIG_SCENE_EVAL, "--validate",
                     "--device", "cuda", *overrides],
        (attention, blend_kernel))
    out_dir, seconds = record["out_dir"], record["seconds"]
    scenes, overflow = record["scenes"], record["overflow"]
    drop_record(torch, record)
    files = os.listdir(out_dir)
    with GcClock() as gc_clock:
        t0 = time.perf_counter()
        metrics = eval_scene_result.main(["--result_dir", out_dir])
        metric_s = time.perf_counter() - t0
    want = expected_counts(sample_views=(n_in,), samples=b,
                           path_frames=b * ((n_in - 1) * PATH_STEPS + 1))
    split = {k: seconds[k] for k in ("load", "sampler", "dumps",
                                     "trajectory_videos",
                                     "ply_and_path_video")}
    batch_s = sum(split.values())
    out = {"tree": {"scenes": SCENES, "frames": SCENE_FRAMES,
                    "frame_hw": list(RE10K_HW), "write_s": tree_s},
           "scenes": scenes, "batch_seconds": batch_s,
           "seconds_per_scene": batch_s / b,
           "split_seconds": split,
           "setup_seconds": seconds["setup"], "call": call,
           "max_memory_allocated_bytes": call["max_memory_allocated_bytes"],
           "overflow": overflow, "launches": counts,
           "expected_launches": want,
           "metric_cli": metrics, "metric_cli_seconds": metric_s,
           "metric_cli_gc_seconds": gc_clock.seconds,
           "batch": f"b={b}, {n_in} views at "
                    f"{cfg.data['training_res'][0]}^2 from "
                    f"{RE10K_HW[0]}x{RE10K_HW[1]} frames",
           "overrides": overrides, "card": card_line()}
    print(f"[14 scene eval] {json.dumps(out)}", flush=True)
    for suffix, n in ((".npz", b), ("_traj_xt.avi", b),
                      ("_traj_xstart.avi", b), (".ply", b),
                      ("_path.avi", b), (".png", b)):
        got = sum(f.endswith(suffix) for f in files)
        if got != n:
            raise AssertionError(f"{got} files *{suffix}, want {n}")
    if "val_metrics.json" not in files:
        raise AssertionError("no val_metrics.json")
    if counts != want:
        raise AssertionError(f"scene eval launches {counts} != {want}")
    if not (np.isfinite(metrics["psnr"]) and np.isfinite(metrics["ssim"])
            and metrics["num_scenes"] == b):
        raise AssertionError(f"metric CLI: {metrics}")
    dump = os.path.join(out_dir, sorted(f for f in files
                                        if f.endswith(".npz"))[0])
    out["lpips"] = scene_eval_lpips(torch, dev, tmp, out_dir, dump, metrics)
    return out


def synthetic_lpips_npz(torch, tmp: str) -> str:
    """The port's tools/convert_lpips_weights.py on seeded full-spec
    torchvision-VGG16 and lpips-head state dicts written with torch.save;
    the NPZ's path."""
    import numpy as np

    from open_diffusiongs_tpu_torch.tools import convert_lpips_weights as clp
    rng = np.random.default_rng(2024)
    vgg, lin, cin = {}, {}, 3

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    for si, idxs in enumerate(clp.STAGE_CONV_IDXS):
        cout = clp.VGG_STAGES[si][0]
        for i in idxs:
            vgg[f"features.{i}.weight"] = t(rng.normal(
                0, np.sqrt(2.0 / (9 * cin)), (cout, cin, 3, 3)))
            vgg[f"features.{i}.bias"] = t(rng.normal(0, 0.05, (cout,)))
            cin = cout
        lin[f"lin{si}.model.1.weight"] = t(np.abs(rng.normal(
            0, 0.05, (1, cout, 1, 1))))
    vgg_path, lin_path, npz = (os.path.join(tmp, n) for n in
                               ("vgg16.pth", "vgg.pth", "lpips_vgg.npz"))
    torch.save(vgg, vgg_path)
    torch.save(lin, lin_path)
    clp.main(["--vgg16", vgg_path, "--lin", lin_path, "--out", npz])
    return npz


def scene_eval_lpips(torch, dev, tmp: str, out_dir: str, dump: str,
                     metrics: dict) -> dict:
    """14's LPIPS: the metric CLI with --lpips-weights on the converter's
    NPZ, and one scene's LPIPS on the card against the CPU."""
    import numpy as np

    from open_diffusiongs_tpu_torch import eval_scene_result
    from open_diffusiongs_tpu_torch.systems import losses
    npz = synthetic_lpips_npz(torch, tmp)
    t0 = time.perf_counter()
    with_lpips = eval_scene_result.main(["--result_dir", out_dir,
                                         "--lpips-weights", npz])
    cli_s = time.perf_counter() - t0
    render, gt = (torch.from_numpy(a) for a in
                  eval_scene_result.load_result(dump))
    with torch.no_grad():
        card = losses.compute_metrics(
            gt.to(dev), render.to(dev),
            losses.lpips_init_params(npz, device=dev))["lpips"].cpu()
        cpu = losses.compute_metrics(
            gt, render, losses.lpips_init_params(npz))["lpips"]
    rel = float(((card - cpu).abs() / cpu.abs()).max())
    out = {"metric_cli": with_lpips, "metric_cli_seconds": cli_s,
           "scene": os.path.basename(dump), "card": card.tolist(),
           "cpu": cpu.tolist(), "max_rel_err": rel}
    print(f"[14 scene eval lpips] {json.dumps(out)}", flush=True)
    if not np.isfinite(with_lpips.get("lpips", np.nan)):
        raise AssertionError(f"metric CLI with LPIPS: {with_lpips}")
    if (with_lpips["psnr"], with_lpips["ssim"]) != (metrics["psnr"],
                                                    metrics["ssim"]):
        raise AssertionError("metric CLI: PSNR / SSIM moved with LPIPS on")
    if not rel <= LPIPS_RTOL:
        raise AssertionError(f"14: scene LPIPS card vs CPU {rel:.3g} > "
                             f"{LPIPS_RTOL}")
    return out


# ---------------------------------------------------------------------------
# 15. The serving surface: the density kernel, mesh export, W8A8 serving,
#     U²-Net matting and the CLI
# ---------------------------------------------------------------------------

DENSITY_TOL = dict(atol=1e-5, rtol=1e-5)   # kernel vs twin, f32 sums
DENSITY_ISO = 0.005                        # extract_mesh's density_thresh
ISO_COUNT_REL = 1e-4                       # iso crossings, kernel vs twin
# live pairs, kernel counter vs twin count on the same slabs: the two round
# the power apart, so only pairs within a few ulps of -104 or 0 may differ
LIVE_PAIRS_REL = 1e-6
# f32 operations a (point, Gaussian) pair needs: the offset (3), the
# quadratic form (15), the tests (2), opacity x weight and the sum (2),
# the exponential's argument (3); and one exponential a pair, at one
# MUFU.EX2 each: 16 a clock on each of 132 SMs at the 1.98 GHz boost
DENSITY_OPS_PER_PAIR = 25
SFU_PER_S = 16 * 132 * 1.98e9
TWIN_CHUNK_PAIRS = 1 << 26                 # the twin's pairs alive at once
# the twin at 256 runs on every 8th slab (32 of 256; ~11 s a case on all of
# them), and the kernel is timed on those too.  Every slab runs the same
# code on its own list and z range, so 32 planes spread over the grid, one
# case with a surface on them, hold every path of the kernel
TWIN_SLAB_STRIDE_256 = 8
MESH_VERTS_REL = 1e-3                      # kernel vs twin grid's meshes
# gaussian_density_grid's host split (ops/mesh.py)
DENSITY_STAGES = ("density_inputs", "density_selection", "density_field",
                  "density_copy")
BALL_RES = 256
INT8_PEAK = 1979e12                        # dense int8 TOPS (data sheet)
QUANT = "system.shape_model.quant_int8=true"
# the TPU's f32 reference figure for W8A8 (docs/PERF_NOTES.md), printed
# beside this run's PSNR; not a bar
JAX_INT8_PSNR_DB = 39.4
QUANT_SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
U2NET_MAX_ERR, U2NET_MEAN_ERR = 1.5e-3, 1e-5   # the golden's bars
U2NET_SIZE = 320


def shell_gaussians(n: int, seed: int):
    """n Gaussians on a shell of radius 0.5-0.6 with small anisotropic
    scales, random rotations and opacities (NumpyGaussians)."""
    import numpy as np
    from open_diffusiongs_tpu_torch.ops.gaussians import NumpyGaussians
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return NumpyGaussians(
        xyz=(dirs * rng.uniform(0.5, 0.6, (n, 1))).astype(np.float32),
        features=np.zeros((n, 1, 3), np.float32),
        scaling=rng.uniform(-4.5, -3.5, (n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(1.0, 1.0, (n, 1)).astype(np.float32))


def ball_gaussians():
    """The 300-Gaussian ball of tests/test_mesh.py:74-93."""
    import numpy as np
    from open_diffusiongs_tpu_torch.ops.gaussians import NumpyGaussians
    rng = np.random.default_rng(0)
    n = 300
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = dirs * rng.uniform(0, 0.3, (n, 1))
    return NumpyGaussians(
        pts.astype(np.float32), np.zeros((n, 1, 3), np.float32),
        np.full((n, 3), -3.0, np.float32),
        np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1)),
        np.full((n, 1), 2.0, np.float32))


def density_args(torch, dev, g, res: int):
    """ops/mesh.py's steps for g at res up to the kernel: density_inputs,
    the card's selection (slab_select), held equal to slab_tables's numpy
    loop table for table (a mismatch raises); the kernel's arguments on
    the card, slab_rows, center and scale."""
    import numpy as np
    from open_diffusiongs_tpu_torch.ops import mesh
    xyz_n, inv, opa, center, scale = mesh.density_inputs(g)
    gauss = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
             for x in (xyz_n, inv, opa)]
    *tables, rows = mesh.slab_select(gauss[0], gauss[2], res)
    want = mesh.slab_tables(xyz_n, opa, res)
    for name, got, w in zip(("lin", "slab_z", "idx", "counts"), tables,
                            want):
        if not np.array_equal(got.cpu().numpy(), w):
            raise AssertionError(f"slab_select's {name} differs from "
                                 f"slab_tables's at res {res}")
    if rows != want[4]:
        raise AssertionError(f"slab_rows {rows} vs {want[4]}")
    return tables + gauss, rows, center, scale


def iso_crossings(grid, iso: float = DENSITY_ISO) -> int:
    """Grid edges (along x, y and z) whose ends lie on both sides of iso."""
    above = grid > iso
    return int(sum(int((above.narrow(d, 1, grid.shape[d] - 1)
                        != above.narrow(d, 0, grid.shape[d] - 1)).sum())
                   for d in range(3)))


def same_bits(torch, a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def density_bound(live: int, nbytes: int) -> dict:
    """The least time of the density work these inputs need: `live` pairs
    (f32 power in (-104, 0]) at DENSITY_OPS_PER_PAIR f32 operations on the
    FP32 pipe and one exp each at SFU_PER_S, or `nbytes` at the HBM rate."""
    t_ops = live * DENSITY_OPS_PER_PAIR / PEAK_OPS["f32"]
    t_exp = live / SFU_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ms": 1e3 * max(t_ops, t_exp, t_bytes),
            "by": "operations" if max(t_ops, t_exp) >= t_bytes else "bytes",
            "ops_ms": 1e3 * t_ops, "exp_ms": 1e3 * t_exp,
            "bytes_ms": 1e3 * t_bytes}


def tie_order_effect(torch, dev, args, rows: int, grid, xyz_n, opa,
                     relax: float = 0.1) -> dict:
    """What the port's rule for equal opacities (ascending index) changes
    against JAX's own call, np.argsort's default (not stable): the capped
    slabs, those whose list differs in order, those whose members differ,
    and the kernel's grid from JAX's lists against `grid` (the port's)."""
    import numpy as np
    from open_diffusiongs_tpu_torch.ops import mesh
    lin_t, slab_z_t, idx_t, counts_t = args[:4]
    lin, slab_z = lin_t.cpu().numpy(), slab_z_t.cpu().numpy()
    idx, counts = idx_t.cpu().numpy(), counts_t.cpu().numpy()
    cap = idx.shape[1]
    jax_idx = idx.copy()
    capped = order = members = 0
    for s in np.nonzero(counts == cap)[0]:
        z0, z1 = slab_z[s]
        vmin = np.stack([lin[0], lin[0], lin[z0]]) - relax
        vmax = np.stack([lin[-1], lin[-1], lin[z1 - 1]]) + relax
        cand = np.nonzero(((xyz_n > vmin) & (xyz_n < vmax)).all(-1))[0]
        if len(cand) <= cap:
            continue
        capped += 1
        jax_idx[s] = cand[np.argsort(-opa[cand])[:cap]]   # JAX's call
        order += not np.array_equal(jax_idx[s], idx[s])
        members += not np.array_equal(np.sort(jax_idx[s]), np.sort(idx[s]))
    rec = mesh.density_records(torch.from_numpy(jax_idx).to(dev), *args[4:])
    grid_jax = mesh.density_kernel(lin_t, slab_z_t, counts_t, rec, rows)
    diff = (grid_jax - grid).abs()
    return {"capped_slabs": capped, "order_differs": order,
            "members_differ": members,
            "points_differ": int((diff > 0).sum()),
            "max_abs_diff": float(diff.max()),
            "iso_crossings_jax_order": iso_crossings(grid_jax),
            "iso_crossings": iso_crossings(grid)}


def density_case(torch, dev, g, res: int, label: str,
                 twin_stride: int = 1) -> tuple:
    """The density stage for g at res: ops/mesh.py::gaussian_density_grid
    itself, split into host seconds at synchronized edges (inputs,
    selection, field, copy); the card's selection held equal to
    slab_tables's; the kernel with the cull bit-identical to the kernel
    without it and to the path's grid; both against density_grid_ref on
    the card, the twin on every `twin_stride`-th slab (the grids compared
    on those slabs' z planes); the live pairs (the kernel's counters on
    all slabs and on the twin's, the twin's own count there), the
    evaluated pairs, the box tests, the bound these inputs need beside
    the all-pairs bound, the kernel by CUDA events with the cull on and
    off, the wrapper (records + extents + kernel) and the twin by the
    host clock; what the tie rule changes (tie_order_effect).  Returns the
    record and gaussian_density_grid's result (grid on the host, center,
    scale)."""
    from open_diffusiongs_tpu_torch.ops import mesh
    split = {}
    t0 = time.perf_counter()
    grid_host, center, scale = mesh.gaussian_density_grid(
        g, res, device=dev, stage_seconds=split)
    density_s = time.perf_counter() - t0
    args, rows, _, _ = density_args(torch, dev, g, res)
    lin, slab_z, idx, counts = args[:4]
    rec = mesh.density_records(idx, *args[4:])
    grid = mesh.density_kernel(lin, slab_z, counts, rec, rows)
    grid_all = mesh.density_kernel(lin, slab_z, counts, rec, rows,
                                   cull=False)
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    grid_counted = mesh.density_kernel(lin, slab_z, counts, rec, rows,
                                       counters=counters)
    live, evaluated, tile_tests = counters.tolist()
    cull_exact = same_bits(torch, grid, grid_all)
    path_exact = same_bits(torch, grid, torch.from_numpy(grid_host).to(dev))
    counted_exact = same_bits(torch, grid, grid_counted)
    ties = tie_order_effect(torch, dev, args, rows, grid,
                            args[4].cpu().numpy(), args[6].cpu().numpy())

    sub = [a[::twin_stride].contiguous() if i in (1, 2, 3) else a
           for i, a in enumerate(args)]
    rec_sub = rec[::twin_stride].contiguous()
    zs = torch.cat([torch.arange(int(z0), int(z1), device=dev)
                    for z0, z1 in sub[1].tolist()])
    live_twin = torch.zeros(1, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = mesh.density_grid_ref(*sub, chunk_pairs=TWIN_CHUNK_PAIRS,
                                live=live_twin)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    counters_sub = torch.zeros(3, dtype=torch.int64, device=dev)
    mesh.density_kernel(lin, sub[1], sub[3], rec_sub, rows,
                        counters=counters_sub)
    ref = ref[:, :, zs]
    over, errs = 0, []
    for k in (grid, grid_all):
        err = (k[:, :, zs] - ref).abs()
        errs.append(float(err.max()))
        over += int((err > DENSITY_TOL["atol"]
                     + DENSITY_TOL["rtol"] * ref.abs()).sum())
    iso_k, iso_r = iso_crossings(grid[:, :, zs]), iso_crossings(ref)
    ms = cuda_ms(lambda: mesh.density_kernel(lin, slab_z, counts, rec, rows),
                 iters=5)
    ms_no_cull = cuda_ms(lambda: mesh.density_kernel(
        lin, slab_z, counts, rec, rows, cull=False), iters=2)
    ms_wrapper = cuda_ms(lambda: mesh.density_grid(*args, slab_rows=rows),
                         iters=5)
    ms_sub = cuda_ms(lambda: mesh.density_kernel(lin, sub[1], sub[3],
                                                 rec_sub, rows), iters=5)
    pts = (slab_z[:, 1] - slab_z[:, 0]).long() * res * res
    pairs = int((counts.long() * pts).sum())
    # the all-pairs bound: every pair of the lists, the unpacked inputs
    # and the grid (the first design's work)
    old = density_bound(pairs, sum(a.numel() * a.element_size()
                                   for a in args) + grid.numel() * 4)
    # these inputs' bound: the live pairs, the packed lists read once and
    # the grid written once
    new = density_bound(live, int(counts.long().sum()) * rec.shape[2] * 4
                        + sum(a.numel() * a.element_size()
                              for a in (lin, slab_z, counts))
                        + grid.numel() * 4)
    out = {"view": label, "res": res, "gaussians": int(g.xyz.shape[0]),
           "slabs": int(counts.numel()), "max_list": int(counts.max()),
           "list_entries": int(counts.long().sum()),
           "pairs": pairs, "live_pairs": live, "evaluated_pairs": evaluated,
           "tile_tests": tile_tests,
           "live_pairs_twin_slabs": int(counters_sub[0]),
           "live_pairs_twin": int(live_twin), "max_abs_err": max(errs),
           "max_abs_err_no_cull": errs[1], "over_tol": over,
           "cull_bit_identical": cull_exact,
           "path_bit_identical": path_exact,
           "counted_bit_identical": counted_exact, "ties": ties,
           "max": float(ref.max()),
           "iso_crossings": iso_k, "iso_crossings_twin": iso_r,
           "ms": ms, "ms_no_cull": ms_no_cull, "ms_wrapper": ms_wrapper,
           "plain_ms": plain_ms, "twin_slabs": int(sub[3].numel()),
           "twin_pairs": int((sub[3].long() * (sub[1][:, 1] - sub[1][:, 0])
                              .long() * res * res).sum()),
           "ms_on_twin_slabs": ms_sub, "density_s": density_s,
           "density_split": split,
           "bound_ms": new["ms"], "bound_by": new["by"],
           "bound_ops_ms": new["ops_ms"], "bound_exp_ms": new["exp_ms"],
           "bound_bytes_ms": new["bytes_ms"],
           "bound_all_pairs_ms": old["ms"],
           "bound_all_pairs_by": old["by"], "sfu_exp_per_s": SFU_PER_S,
           "card": card_line()}
    print(f"[15a density, {label}] {json.dumps(out)}", flush=True)
    if not (cull_exact and path_exact and counted_exact):
        raise AssertionError(f"density kernel ({label}): the culled grid "
                             f"is not bit-identical to the unculled one "
                             f"({cull_exact}), to gaussian_density_grid's "
                             f"({path_exact}) or to the counted launch's "
                             f"({counted_exact})")
    if abs(int(counters_sub[0]) - int(live_twin)) > (LIVE_PAIRS_REL
                                                     * int(live_twin)):
        raise AssertionError(f"live pairs ({label}): kernel "
                             f"{int(counters_sub[0])} vs twin "
                             f"{int(live_twin)} on the twin's slabs")
    if over or not bool(torch.isfinite(grid).all()):
        raise AssertionError(f"density kernel vs twin ({label}): {over} "
                             f"points over {DENSITY_TOL}")
    if abs(iso_k - iso_r) > ISO_COUNT_REL * iso_r:
        raise AssertionError(f"iso crossings {iso_k} vs twin {iso_r}")
    return out, (grid_host, center, scale)


def phase_density(torch, dev, g256, g512) -> tuple:
    """15a: the kernel against its twin on a synthetic shell of 20k
    Gaussians at 128, on phase 5's filtered Gaussians at 256 (the main
    path's input; its field lies wholly above or below the level on most
    planes) and on phase 11's trained-statistics 512^2 Gaussians at 256 (a
    foam of small blobs: a surface on every plane).  Returns the records
    and the trained Gaussians' density field for 15b."""
    cases = [density_case(torch, dev, shell_gaussians(20_000, 7), 128,
                          "shell 20k, 128")[0],
             density_case(torch, dev, g256, RES, f"phase 5 asset, {RES}",
                          twin_stride=TWIN_SLAB_STRIDE_256)[0]]
    trained, field = density_case(
        torch, dev, g512, RES, f"{RES_512}^2 trained statistics, {RES}",
        twin_stride=TWIN_SLAB_STRIDE_256)
    torch.cuda.empty_cache()
    return cases + [trained], field


def point_triangle_distance(torch, p, a, b, c):
    """Distance from points p to triangles (a, b, c), all [..., 3]: the
    projection onto the plane where it falls inside the triangle, else the
    nearest of the three edges (the closest point of a triangle lies in
    its interior or on its boundary)."""
    def seg(p, u, v):
        d = v - u
        t = ((p - u) * d).sum(-1) / (d * d).sum(-1).clamp_min(1e-30)
        return (p - u - t.clamp(0, 1)[..., None] * d).norm(dim=-1)

    n = torch.cross(b - a, c - a, dim=-1)
    nn2 = (n * n).sum(-1)
    h = ((p - a) * n).sum(-1) / nn2.clamp_min(1e-30)
    q = p - h[..., None] * n
    inside = nn2 > 1e-30
    for u, v in ((a, b), (b, c), (c, a)):
        inside &= (torch.cross(v - u, q - u, dim=-1) * n).sum(-1) >= 0
    edges = torch.minimum(torch.minimum(seg(p, a, b), seg(p, b, c)),
                          seg(p, c, a))
    return torch.where(inside, (h.abs() * nn2.sqrt()), edges)


def mesh_hausdorff(torch, dev, mesh_a, mesh_b, k: int = 64,
                   chunk: int = 2048) -> float:
    """Symmetric Hausdorff distance between two triangle meshes, sampled at
    their vertices: the largest distance from a vertex of one to the
    surface of the other, on the card.  Each vertex is measured against
    the triangles of the other mesh around its nearest vertex there and
    the k whose centroids are nearest; a closer triangle outside them
    would only make the value larger (the check stays conservative)."""
    def one_way(verts, other):
        ov, ot = (torch.from_numpy(x).to(dev) for x in other)
        ot = ot.long()
        tri = ov[ot]                                          # [F, 3, 3]
        cen = tri.mean(1)
        # the triangles around each vertex, padded with -1
        flat = ot.reshape(-1)
        order = torch.argsort(flat, stable=True)
        deg = torch.bincount(flat, minlength=len(ov))
        start = torch.cumsum(deg, 0) - deg
        slot = torch.arange(len(flat), device=dev) - start[flat[order]]
        around = torch.full((len(ov), int(deg.max())), -1, device=dev,
                            dtype=torch.long)
        around[flat[order], slot] = order // 3
        p_all = torch.from_numpy(verts).to(dev)
        worst = 0.0
        for i in range(0, len(p_all), chunk):
            p = p_all[i:i + chunk]
            nearest_v = torch.cdist(p, ov).argmin(1)
            cand = torch.cat([around[nearest_v], torch.cdist(p, cen).topk(
                k, largest=False).indices], 1)
            t = tri[cand.clamp_min(0)]                        # [P, c, 3, 3]
            d = point_triangle_distance(torch, p[:, None], t[..., 0, :],
                                        t[..., 1, :], t[..., 2, :])
            d = torch.where(cand >= 0, d, float("inf"))
            worst = max(worst, float(d.amin(1).max()))
        return worst
    return max(one_way(mesh_a[0], mesh_b), one_way(mesh_b[0], mesh_a))


def mesh_record(label: str, n_gaussians: int, verts, tris, split: dict,
                obj_dir: str) -> dict:
    """A mesh's size and host split (extract_mesh's steps, then its OBJ,
    written here)."""
    import numpy as np
    from open_diffusiongs_tpu_torch.ops import mesh
    t0 = time.perf_counter()
    path = os.path.join(obj_dir, re.sub(r"\W", "_", label) + ".obj")
    mesh.save_mesh_obj(path, verts, tris)
    split = dict(split, obj=time.perf_counter() - t0)
    if not (len(tris) > 0 and np.isfinite(verts).all()):
        raise AssertionError(f"mesh of {label}: {len(tris)} tris")
    return {"view": label, "gaussians": n_gaussians,
            "seconds": sum(split.values()), "stages_s": split,
            "verts": len(verts), "tris": len(tris),
            "obj_bytes": os.path.getsize(path), "card": card_line()}


def phase_mesh_export(torch, dev, system, g512, field512,
                      density512_split: dict) -> dict:
    """15b: the ball's mesh at 256 (tests/test_mesh.py's bars; the
    kernel's grid against the twin's); phase 5's input through
    pipe.batch(extract_mesh=True) with phase 5's system (parked on the
    host since phase 7), with extract_mesh's host split; and phase 11's
    trained-statistics 512^2 Gaussians (not sampled again), meshed by
    mesh_from_grid from 15a's density field of them (extract_mesh's
    second step; its density split is 15a's)."""
    import numpy as np
    from open_diffusiongs_tpu_torch.ops import mesh
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    t0 = time.perf_counter()
    args, rows, center, scale = density_args(torch, dev, ball_gaussians(),
                                             BALL_RES)
    grids = {"kernel": mesh.density_grid(*args, slab_rows=rows),
             "twin": mesh.density_grid_ref(*args,
                                           chunk_pairs=TWIN_CHUNK_PAIRS)}
    grids = {k: v.cpu().numpy() for k, v in grids.items()}
    voxel = 2.0 / (BALL_RES - 1) / scale          # world units
    meshes = {k: mesh.mesh_from_grid(v, center, scale, density_thresh=0.05)
              for k, v in grids.items()}
    (kv, kt), (tv, _) = meshes["kernel"], meshes["twin"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ball.obj")
        mesh.save_mesh_obj(path, kv, kt)
        with open(path) as f:
            head = f.readline()
        ball = {"verts": len(kv), "tris": len(kt), "verts_twin": len(tv),
                "max_radius": float(np.linalg.norm(kv, axis=1).max()),
                "hausdorff": mesh_hausdorff(torch, dev, meshes["kernel"],
                                            meshes["twin"]),
                "voxel": float(voxel), "seconds": time.perf_counter() - t0}
        print(f"[15b mesh, ball] {json.dumps(ball)}", flush=True)
        if not (len(kv) > 50 and len(kt) > 50 and ball["max_radius"] < 0.6
                and head.startswith("v ")):
            raise AssertionError(f"ball mesh fails tests/test_mesh.py's "
                                 f"bars: {ball}")
        if (abs(len(kv) - len(tv)) > MESH_VERTS_REL * len(tv)
                or ball["hausdorff"] > voxel):
            raise AssertionError(f"kernel vs twin grid meshes: {ball}")

        t0 = time.perf_counter()
        system.model.to(dev)
        torch.cuda.synchronize()
        unpark_s = time.perf_counter() - t0
        stages = {}
        mesh.LAUNCHES = 0
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            out = DiffusionGSPipeline(system).batch(
                [IMAGE], resolution=RES, n_views=N_VIEWS, matting="border",
                extract_mesh=True, stage_seconds=stages)[0]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = mesh.LAUNCHES
        system.model.to("cpu")
        torch.cuda.empty_cache()
        if launches != 1 or out.mesh is None:
            raise AssertionError(f"pipe.batch(extract_mesh=True): "
                                 f"{launches} density launches")
        asset = mesh_record(f"{RES}^2 asset", int(out.gaussians.xyz.shape[0]),
                            *out.mesh, out.mesh_seconds, tmp)
        asset.update(batch_seconds=secs, batch_stages_s=stages,
                     gc_seconds=gc_clock.seconds, launches=launches,
                     unpark_s=unpark_s)
        print(f"[15b mesh, {RES}^2 asset] {json.dumps(asset)}", flush=True)
        split = dict(density512_split)
        verts, tris = mesh.mesh_from_grid(*field512, stage_seconds=split)
        trained = mesh_record(f"{RES_512}^2 trained statistics",
                              int(g512.xyz.shape[0]), verts, tris, split, tmp)
        print(f"[15b mesh, {RES_512}^2 trained statistics] "
              f"{json.dumps(trained)}", flush=True)
        print("[15b density split] " + json.dumps({
            view: {k: r["stages_s"][k] for k in DENSITY_STAGES}
            for view, r in ((f"{RES}^2 asset", asset),
                            (f"{RES_512}^2 trained", trained))}
            | {"card": card_line()}), flush=True)
    return {"ball": ball, "asset": asset, "trained_512": trained}


def psnr(a, b) -> float:
    import numpy as np
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * float(np.log10(1.0 / mse)) if mse > 0 else float("inf")


def phase_int8(torch, dev, bf16_renders) -> dict:
    """15c: one 256^2 asset with quant_int8 (phase 5's weights and seed),
    timed by the host clock while torch.profiler traces the card's
    kernels (CUDA activity only, so the device ms are the same call's),
    its int8 products counted (sample_asset's gate: 24 x 4 x 30), its
    renders against phase 5's; then QuantLinear against the bf16 Linear
    at the DiT's shapes, each beside its bound."""
    import numpy as np
    from open_diffusiongs_tpu_torch.models.transformer import Linear
    from open_diffusiongs_tpu_torch.ops import quant
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    system = build_system(torch, dev, overrides=(QUANT,))
    blk = system.model.transformer[0]
    if not all(isinstance(m, quant.QuantLinear) for m in
               (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2)):
        raise AssertionError("quant_int8 did not build QuantLinears")
    keep, got = [], []
    pipe = DiffusionGSPipeline(system)
    # no warm-up: every kernel and shape but _int_mm's was made by phase 5
    device_ms = sum(device_ms_by_kernel(
        torch, lambda: got.append(sample_asset(
            torch, dev, pipe, RES, "15c W8A8 256^2 asset", profiled=False,
            warm_up=False, keep=keep)),
        iters=1, warm_up=False).values())
    asset, renders = got[0], keep[0].renders
    del system, pipe, keep
    torch.cuda.empty_cache()
    if np.array_equal(renders, bf16_renders):
        raise AssertionError("W8A8 renders equal the bf16 ones: the int8 "
                             "path did not run")
    out = {"seconds_per_asset": asset["seconds_per_asset"],
           "device_ms_per_asset": device_ms,
           "traced_by": "torch.profiler, CUDA activity",
           "stages_s": asset["stages_s"],
           "int8_mm_launches": asset["launches"]["int8_mm"],
           "psnr_vs_bf16_db": psnr(renders, bf16_renders),
           "jax_tpu_f32_reference_psnr_db": JAX_INT8_PSNR_DB, "gemms": []}
    gen = torch.Generator(device=dev).manual_seed(3)
    for m in (4098, 16386):
        for k, n in QUANT_SHAPES:
            x = torch.randn((1, m, k), generator=gen, device=dev
                            ).to(torch.bfloat16)
            ql = quant.QuantLinear(k, n, compute_dtype=torch.bfloat16
                                   ).to(dev)
            bl = Linear(k, n, compute_dtype=torch.bfloat16).to(dev)
            bl.load_state_dict(ql.state_dict())
            with torch.no_grad():
                int8_ms = cuda_ms(lambda: ql(x), iters=20)
                bf16_ms = cuda_ms(lambda: bl(x), iters=20)
            ops = 2 * m * k * n
            out["gemms"].append({
                "m": m, "k": k, "n": n, "int8_ms": int8_ms,
                "bf16_ms": bf16_ms,
                # x and y in bf16; the f32 master weight and bias
                "int8_bound_ms": 1e3 * max(
                    ops / INT8_PEAK, (2 * m * k + 4 * n * k + 4 * n
                                      + 2 * m * n) / HBM_BYTES_PER_S),
                "bf16_bound_ms": 1e3 * max(
                    ops / PEAK_OPS["bf16"], (2 * m * k + 4 * n * k + 4 * n
                                             + 2 * m * n) / HBM_BYTES_PER_S)})
            del x, ql, bl
    out["card"] = card_line()
    print(f"[15c W8A8] {json.dumps(out)}", flush=True)
    return out


def phase_u2net_cli(torch, dev) -> dict:
    """15d: U²-Net (synthetic weights of the full u2net spec, written as
    the converter's NPZ into a temporary directory): u2net_alpha at 320^2
    timed, the card's d0 against the same module on the CPU; then
    run.main(["--matting", "u2net", "--extract-mesh", ...]) with
    U2NET_NPZ set: PLY, renders and a non-empty mesh.obj."""
    import numpy as np
    from PIL import Image

    from open_diffusiongs_tpu_torch import run
    from open_diffusiongs_tpu_torch.ops import mesh
    from open_diffusiongs_tpu_torch.utils import u2net
    params = u2net.synth_params(u2net.U2NET_FULL)
    net = u2net.U2Net(params, u2net.U2NET_FULL).to(dev)
    rgb = np.asarray(Image.open(IMAGE).convert("RGB"))
    alpha_ms = cuda_ms(lambda: u2net.u2net_alpha(net, rgb), iters=5)
    x = torch.randn((1, 3, U2NET_SIZE, U2NET_SIZE),
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(x.to(dev)), iters=5)
        d0 = net(x.to(dev))[0].cpu()
        d0_cpu = u2net.U2Net(params, u2net.U2NET_FULL)(x)[0]
    err = (d0 - d0_cpu).abs()
    out = {"alpha_ms": alpha_ms, "forward_ms": fwd_ms,
           "d0_max_err": float(err.max()), "d0_mean_err": float(err.mean())}
    if not (out["d0_max_err"] < U2NET_MAX_ERR
            and out["d0_mean_err"] < U2NET_MEAN_ERR):
        raise AssertionError(f"U²-Net card vs CPU: {out}")
    del net
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "u2net.npz")
        np.savez(npz, **params)
        dest = os.path.join(tmp, "out")
        prev = os.environ.get("U2NET_NPZ")
        os.environ["U2NET_NPZ"] = npz
        mesh.LAUNCHES = 0
        try:
            t0 = time.perf_counter()
            run.main(["--image", IMAGE, "--matting", "u2net",
                      "--extract-mesh", "--out", dest])
            torch.cuda.synchronize()
            out["cli_seconds"] = time.perf_counter() - t0
        finally:
            if prev is None:
                os.environ.pop("U2NET_NPZ")
            else:
                os.environ["U2NET_NPZ"] = prev
        out["cli_density_launches"] = mesh.LAUNCHES
        files = sorted(os.listdir(dest))
        out["cli_files"] = files
        out["mesh_obj_bytes"] = os.path.getsize(os.path.join(dest,
                                                             "mesh.obj"))
    out["card"] = card_line()
    print(f"[15d u2net + CLI] {json.dumps(out)}", flush=True)
    want = {"gaussians.ply", "input_processed.png", "mesh.obj"} | {
        f"render_{i}.png" for i in range(N_VIEWS)}
    if not (want <= set(files) and out["mesh_obj_bytes"] > 0
            and out["cli_density_launches"] == 1):
        raise AssertionError(f"run --matting u2net --extract-mesh: {out}")
    return out


def phase_serving(torch, dev, system, g256, bf16_renders, g512) -> dict:
    """15: a-d, each part's host seconds."""
    seconds = {}
    out = {}

    def part(key, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(torch, dev, *args)
        seconds[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out[key]

    out["density"], field512 = part("density", phase_density, g256, g512)
    part("mesh", phase_mesh_export, system, g512, field512,
         out["density"][2]["density_split"])
    part("int8", phase_int8, bf16_renders)
    part("u2net_cli", phase_u2net_cli)
    out["seconds"] = seconds
    print(f"[15 serving surface] {json.dumps(seconds)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 17: data, ZeRO-1 and sequence parallelism
# ---------------------------------------------------------------------------

# (b, Lp, sp, L): the ring's shapes; each gives the two extent pairs a ring
# step meets, a full query shard against the tail shard's keys and the
# tail's queries against a full shard's keys
SPLIT_CASES = ((2, 4608, 2, 4098), (2, 4608, 4, 4098), (1, 16896, 2, 16386))
# bars of the two-rank runs against one process, no looser than phase 6's
PAR_LOSS_REL = 1e-3          # the loss, relative
PAR_REL = GRAD_REL_BOUND     # rel-max 1e-2: grad_norm, the averaged
#                              gradients, the update and the DiT output
PAR_SURE = 0.1               # the update is compared where |g| >= 0.1 of
#                              its tensor's max |g| (AdamW's first steps
#                              move an element by ≈ lr·sign(g); where g is
#                              within bf16 noise of 0 the sign is noise)
PAR_TIMEOUT = 420         # 17b took ~110 s of command (H100, 700 W)


def split_extent_case(torch, dev, gen, b, lp, lq_real, lk_real, h=16, dh=64):
    """#1s and #3 with lq_real != lk_real against their twins (head by
    head) on column slices of a fused qkv, each batch element at its own
    scale; q rows and dO rows >= lq_real and k / v rows >= lk_real hold
    1e4.  Errors over the rows < each output's extent, per element."""
    from open_diffusiongs_tpu_torch.ops import attention
    hd = h * dh
    qkv = torch.randn((b, lp, 3 * hd), generator=gen, device=dev)
    do = torch.randn((b, lp, hd), generator=gen, device=dev)
    qkv *= torch.tensor(QKV_SCALES[:b], device=dev)[:, None, None]
    do *= torch.tensor(DO_SCALES[:b], device=dev)[:, None, None]
    qkv, do = qkv.to(torch.bfloat16), do.to(torch.bfloat16)
    qkv[:, lq_real:, :hd] = 1e4
    qkv[:, lk_real:, hd:] = 1e4
    do[:, lq_real:] = 1e4
    q, k, v = qkv.chunk(3, dim=-1)
    ext = dict(lq_real=lq_real, lk_real=lk_real)
    o, lse = attention.flash_mha_packed(q, k, v, num_heads=h,
                                        with_stats=True, **ext)
    # the ring's forward launch: o in f32, which rounds to the bf16
    # launch's o bit for bit, with the same lse
    o32, lse32 = attention.flash_mha_packed(q, k, v, num_heads=h,
                                            with_stats=True, out_f32=True,
                                            **ext)
    fwd_f32_rounds = bool(torch.equal(o32.to(torch.bfloat16), o)
                          and torch.equal(lse32, lse))
    del o32, lse32
    o_r, lse_r = twin_by_head(torch, attention.flash_mha_packed_ref, h, dh,
                              q, k, v, with_stats=True, **ext)
    grads = attention.flash_mha_packed_bwd(q, k, v, o, do, lse, num_heads=h,
                                           **ext)
    refs = twin_by_head(torch, attention.flash_mha_packed_bwd_ref, h, dh,
                        q, k, v, o, do, lse, **ext)
    # the ring's launch: the same kernel writing f32, which rounds to the
    # bf16 launch's outputs bit for bit
    g32 = attention._bwd_fused(q, k, v, o, do, lse, h, lq_real, lk_real,
                               out_f32=True)
    f32_rounds = bool(torch.equal(g32.to(torch.bfloat16),
                                  torch.cat(grads, -1)))
    del g32
    torch.cuda.synchronize()

    def rel(out, ref):
        return max(rel_max(out[i], ref[i]) for i in range(b))

    res = {"lq_real": lq_real, "lk_real": lk_real,
           "o_rel_max": rel(o[:, :lq_real], o_r[:, :lq_real]),
           "lse_max_abs": float((lse - lse_r)[:, :lq_real].abs().max()),
           "lse_pad_zero": bool((lse[:, lq_real:] == 0).all()),
           "fwd_f32_out_rounds_to_bf16_launch": fwd_f32_rounds,
           "f32_out_rounds_to_bf16_launch": f32_rounds}
    for name, g, r, n in zip(("dq", "dk", "dv"), grads, refs,
                             (lq_real, lk_real, lk_real)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"split extents: non-finite {name}")
        res[f"{name}_rel_max"] = rel(g[:, :n], r[:, :n])
        res[f"{name}_max_abs"] = float((g.float() - r.float())[:, :n]
                                       .abs().max())
        res[f"{name}_pad_zero"] = bool((g[:, n:] == 0).all())
    del o_r, lse_r, refs
    return res


def phase_split_extents(torch, dev) -> dict:
    """17a: the ring's split extents on the card (module docstring)."""
    from open_diffusiongs_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = {}
    for b, lp, sp, l in SPLIT_CASES:
        lq = lp // sp
        tail = l - (sp - 1) * lq
        for lq_real, lk_real in ((lq, tail), (tail, lq)):
            cases[f"b={b} Lp={lp} sp={sp} lq={lq_real} lk={lk_real}"] = \
                split_extent_case(torch, dev, gen, b, lq, lq_real, lk_real)
            torch.cuda.empty_cache()
    # equal extents: bit-identical to the one-extent launch
    b, lp, l = 2, 4608, 4098
    qkv = torch.randn((b, lp, 3 * 1024), generator=gen,
                      device=dev).to(torch.bfloat16)
    do = torch.randn((b, lp, 1024), generator=gen,
                     device=dev).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    one = attention.flash_mha_packed(q, k, v, num_heads=16, l_real=l,
                                     with_stats=True)
    two = attention.flash_mha_packed(q, k, v, num_heads=16, lq_real=l,
                                     lk_real=l, with_stats=True)
    g1 = attention.flash_mha_packed_bwd(q, k, v, *one[:1], do, one[1],
                                        num_heads=16, l_real=l)
    g2 = attention.flash_mha_packed_bwd(q, k, v, *one[:1], do, one[1],
                                        num_heads=16, lq_real=l, lk_real=l)
    equal = (all(torch.equal(x, y) for x, y in zip(one, two))
             and all(torch.equal(x, y) for x, y in zip(g1, g2)))
    # one ring step of the 512^2 sp = 2 shape: a full query shard against
    # the tail's keys, forward and backward
    lq, tail = 8448, 16386 - 8448
    qkv = torch.randn((1, lq, 3 * 1024), generator=gen,
                      device=dev).to(torch.bfloat16)
    do = torch.randn((1, lq, 1024), generator=gen,
                     device=dev).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    kw = dict(num_heads=16, lq_real=lq, lk_real=tail)
    o, lse = attention.flash_mha_packed(q, k, v, with_stats=True, **kw)
    step = {"fwd_stats_ms": cuda_ms(lambda: attention.flash_mha_packed(
                q, k, v, with_stats=True, out_f32=True, **kw), 10),
            "bwd_ms": cuda_ms(lambda: attention.flash_mha_packed_bwd(
                q, k, v, o, do, lse, **kw), 10),
            "fwd_stats_bound": attn_fwd_bound(1, lq, tail, 16, 64,
                                              stats=True),
            "shape": f"q [1, {lq}, 16 x 64] over {tail} keys, bf16"}
    del qkv, do, q, k, v, o, lse, one, two, g1, g2
    torch.cuda.empty_cache()
    res = {"cases": cases, "equal_extents_bit_identical": equal,
           "ring_step_L16896_sp2": step,
           "max_abs_err_fwd": max(c["lse_max_abs"] for c in cases.values()),
           "max_abs_err_bwd": max(c[f"{n}_max_abs"] for c in cases.values()
                                  for n in ("dq", "dk", "dv")),
           "card": card_line()}
    print(f"[17a split extents] {json.dumps(res)}", flush=True)
    if not equal:
        raise AssertionError("equal extents differ from the one-extent "
                             "launch")
    for name, r in cases.items():
        if not r["f32_out_rounds_to_bf16_launch"]:
            raise AssertionError(f"split extents {name}: the f32-output "
                                 f"backward does not round to the bf16 one")
        if not r["fwd_f32_out_rounds_to_bf16_launch"]:
            raise AssertionError(f"split extents {name}: the f32-output "
                                 f"forward does not round to the bf16 one")
        checks = [("o rel-max", r["o_rel_max"], ATTN_REL_BOUND),
                  ("lse max abs", r["lse_max_abs"], LSE_ABS_BOUND)]
        checks += [(f"{n} rel-max", r[f"{n}_rel_max"], GRAD_REL_BOUND)
                   for n in ("dq", "dk", "dv")]
        for what, val, bar in checks:
            if not val <= bar:
                raise AssertionError(f"split extents {name}: {what} "
                                     f"{val:.3g} > {bar}")
        for n in ("lse", "dq", "dk", "dv"):
            if not r[f"{n}_pad_zero"]:
                raise AssertionError(f"split extents {name}: {n} past its "
                                     f"extent is not exactly 0")
    return res


def par_setup(torch, dev, config, mesh, zero1=False, bf16=True):
    """`config`'s system (random init from seed 0, no LPIPS; its model
    computing in bf16, or f32), optimizer and state from step 151, and its
    train step, whose draws come from a generator seeded 17 + step (so
    every rank and the one-process run draw the same global batch)."""
    from open_diffusiongs_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer, make_train_step)
    from open_diffusiongs_tpu_torch.systems.builder import (
        build_optimizer_config, build_system)
    from open_diffusiongs_tpu_torch.utils.config import load_config
    cfg = load_config(config, cli_args=["system.use_lpips=false"],
                      makedirs=False)
    system = build_system(cfg.system_type, cfg.system, device=dev, mesh=mesh,
                          bf16=bf16)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    params = dict(system.model.named_parameters())
    opt = make_optimizer(build_optimizer_config(cfg.system, cfg.trainer),
                         params.items(), mesh=mesh, zero1=zero1)
    state = init_train_state(params, opt, ema_decay=0.9999)
    state.step = TRAIN_START_STEP
    step_fn = make_train_step(
        lambda batch, step: system.train_loss(
            batch, step,
            generator=torch.Generator(device=dev).manual_seed(17 + step)),
        opt, ema_decay=0.9999)
    return cfg, system, state, step_fn


def par_steps(torch, state, step_fn, batch, n, on_first=None):
    """n train steps; the seconds of each, the loss and grad_norm of the
    first (`on_first(state)` right after it)."""
    out = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        out.append({"seconds": time.perf_counter() - t0,
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
        if i == 0 and on_first is not None:
            on_first(state)
    return out


def f32_attention(torch):
    """The DiT's packed training attention in f32, through PyTorch's
    scaled_dot_product_attention: a drop-in for
    models.transformer.flash_attention in 17b's f32 reference only."""
    import torch.nn.functional as F

    def attention(qkv, *, num_heads, l_real):
        b, l, hd3 = qkv.shape
        q, k, v = (t.reshape(b, l, num_heads, -1).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        o = F.scaled_dot_product_attention(q, k[:, :, :l_real],
                                           v[:, :, :l_real])
        return o.transpose(1, 2).reshape(b, l, hd3 // 3)
    return attention


def par_reference(torch, dev, config, batch, dit_inputs=None,
                  f32: bool = False, steps: int = 2) -> dict:
    """The one-process step of `config` on `batch`: its raw gradients (a
    post-accumulate hook), the params before and after the first step,
    the loss / grad_norm, a second step's seconds; and the DiT's output
    on `dit_inputs` (no grad) before training.  `f32`: the model computes
    in f32, its attention through `f32_attention`."""
    from open_diffusiongs_tpu_torch.models import transformer
    _, system, state, step_fn = par_setup(torch, dev, config, None,
                                          bf16=not f32)
    ref = {"grads": {}}
    params = state.params
    if dit_inputs is not None:
        with torch.no_grad():
            ref["dit"] = dit_output(torch, system, dit_inputs)
    ref["p0"] = {k: p.detach().clone() for k, p in params.items()}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, k=k: ref["grads"].__setitem__(k, p.grad.detach().clone()))
        for k, p in params.items()]

    def first(_):
        for h in hooks:
            h.remove()
        ref["p1"] = {k: p.detach().clone() for k, p in params.items()}
    packed = transformer.flash_attention
    if f32:
        transformer.flash_attention = f32_attention(torch)
    try:
        ref["steps"] = par_steps(torch, state, step_fn, batch, steps, first)
    finally:
        transformer.flash_attention = packed
    del system, state, step_fn, params
    collect_garbage()
    torch.cuda.empty_cache()
    return ref


def dit_output(torch, system, inputs):
    """The denoiser's Gaussians on (images, ray_o, ray_d, t), flattened
    into one f32 [b, N, C] tensor."""
    g, _ = system.model(*inputs)
    b, n = g.xyz.shape[:2]
    return torch.cat([g.xyz, g.features.reshape(b, n, -1), g.scaling,
                      g.rotation, g.opacity], -1).float()


def par_compare(torch, ref, params, grads) -> dict:
    """Worst-tensor rel-max of the averaged gradients against the
    one-process ones, and of the first update (params - p0) over the
    elements whose one-process |g| >= PAR_SURE of its tensor's max."""
    g_worst = u_worst = 0.0
    zero_tensors = sure = total = 0
    by_tensor, per = {}, {}
    for k, g_ref in ref["grads"].items():
        scale = float(g_ref.abs().max())
        if scale == 0:      # e.g. the free Gaussians' head behind the K cut
            zero_tensors += 1
            g_worst = max(g_worst, float(grads[k].abs().max()))
            per[k] = (float(grads[k].abs().max()), 0.0)
            continue
        diff = grads[k] - g_ref
        err = float(diff.abs().max()) / scale
        by_tensor[k] = (err, scale, float(diff.norm() / g_ref.norm()))
        g_worst = max(g_worst, err)
        mask = g_ref.abs() >= PAR_SURE * scale
        d_ref = (ref["p1"][k] - ref["p0"][k])[mask]
        d = (params[k].detach() - ref["p0"][k])[mask]
        u_err = (float((d - d_ref).abs().max())
                 / max(float(d_ref.abs().max()), 1e-30))
        u_worst = max(u_worst, u_err)
        per[k] = (err, u_err)
        sure += int(mask.sum())
        total += mask.numel()
    worst = sorted(by_tensor.items(), key=lambda kv: -kv[1][0])[:6]
    return {"grad_rel_max": g_worst, "update_rel_max": u_worst,
            "grad_rel_l2_max": max(v[2] for v in by_tensor.values()),
            "worst_grad_tensors": {k: {"rel_max": e, "max_abs_ref": m,
                                       "rel_l2": l2}
                                   for k, (e, m, l2) in worst},
            "update_elements_compared": sure, "elements": total,
            "zero_grad_tensors": zero_tensors, "per_tensor": per}


def excess_error(mine: dict, base: dict) -> dict:
    """Tensor by tensor, how much further `mine` lies from a reference than
    `base` does (par_compare results against the same reference): the
    largest excess of the gradients' and of the update's rel-max."""
    out = {}
    for i, what in enumerate(("grad", "update")):
        k = max(mine["per_tensor"],
                key=lambda k: mine["per_tensor"][k][i]
                - base["per_tensor"][k][i])
        out[f"{what}_rel_max_excess"] = (mine["per_tensor"][k][i]
                                         - base["per_tensor"][k][i])
        out[f"{what}_worst_tensor"] = k
    return out


def summary(compare: dict) -> dict:
    """par_compare's result without its per-tensor table."""
    return {k: v for k, v in compare.items() if k != "per_tensor"}


def averaged_grads(mesh, params) -> dict:
    """This step's .grad of every param averaged over all ranks (the rule
    the optimizer reduced them by)."""
    return {k: mesh.all_reduce_(p.grad.detach().clone()).div_(mesh.world)
            for k, p in params.items()}


def par_dp_zero1(torch, dev, mesh) -> dict:
    """17b i-ii: DDP (dp = 2, b = 2 a rank) against the one-process b = 4
    step on the same batch and draws; ZeRO-1 against that DDP over two
    steps, bit for bit."""
    batch = train_batch(torch, dev, TRAIN_BATCH, RES)
    rows = slice(2 * mesh.data_rank, 2 * mesh.data_rank + 2)
    local = {k: v[rows] for k, v in batch.items()}
    ref = (par_reference(torch, dev, CONFIG, batch) if mesh.rank == 0
           else None)
    mesh.barrier()
    _, system, state, step_fn = par_setup(torch, dev, CONFIG, mesh)
    res = {}

    def first(st):
        avg = averaged_grads(mesh, st.params)
        if ref is not None:
            res["vs_one_process"] = summary(
                par_compare(torch, ref, st.params, avg))
            res["one_process_steps"] = ref["steps"]
            ref.clear()
        del avg
        collect_garbage()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    steps = par_steps(torch, state, step_fn, local, 2, first)
    loss = [mesh.mean_metrics({"loss": torch.tensor(s["loss"])})["loss"]
            for s in steps]
    res["ddp_steps"] = steps
    res["ddp_loss_mean"] = loss
    # peak device bytes of this rank's second step (the one card's memory
    # is shared by both ranks; each counts its own)
    peak = {"ddp": torch.cuda.max_memory_allocated(dev)}
    # DDP's end state, kept on the host so ZeRO-1's peak is its own
    ddp = {"params": {k: p.detach().cpu() for k, p in state.params.items()},
           "ema": {k: v.cpu() for k, v in state.full_ema().items()}}
    sd = state.optimizer.state_dict()
    ddp.update(mu={k: v.cpu() for k, v in sd["mu"].items()},
               nu={k: v.cpu() for k, v in sd["nu"].items()})
    moment_bytes = 4 * sum(v.numel() for v in sd["mu"].values()) * 2
    del system, state, step_fn, sd
    collect_garbage()
    torch.cuda.empty_cache()
    _, system, state, step_fn = par_setup(torch, dev, CONFIG, mesh,
                                          zero1=True)
    opt = state.optimizer
    res["zero1_steps"] = par_steps(
        torch, state, step_fn, local, 2,
        lambda _: torch.cuda.reset_peak_memory_stats(dev))
    peak["zero1"] = torch.cuda.max_memory_allocated(dev)
    res["peak_device_bytes"] = peak
    sd = opt.state_dict()
    got = {"params": state.params, "ema": state.full_ema(), "mu": sd["mu"],
           "nu": sd["nu"]}
    res["zero1_vs_ddp_differing_tensors"] = {
        key: sum(not torch.equal(got[key][k].detach().cpu(), v)
                 for k, v in want.items())
        for key, want in ddp.items()}
    res["zero1_vs_ddp_grad_norm_equal"] = [
        a["grad_norm"] == b["grad_norm"]
        for a, b in zip(res["zero1_steps"], res["ddp_steps"])]
    res["moment_bytes_per_rank"] = {
        "ddp": moment_bytes,
        "zero1": 4 * 2 * sum(t.numel() for t in opt._mu_s)}
    res["ema_bytes_per_rank"] = {
        "ddp": moment_bytes // 2,
        "zero1": 4 * sum(t.numel() for t in state.ema_shard)}
    del system, state, step_fn, opt, sd, got, ddp, ref
    collect_garbage()
    torch.cuda.empty_cache()
    return res


def par_seq(torch, dev, mesh) -> dict:
    """17b iii: sp = 2 on the 512^2 config at b = 1 against the one-process
    step: the DiT's output (no grad), then a train step; #1s and #3
    launches per rank."""
    from open_diffusiongs_tpu_torch.ops import attention
    from open_diffusiongs_tpu_torch.ops.rays import rays_chw
    batch = train_batch(torch, dev, 1, RES_512)
    ray_o, ray_d = rays_chw(batch["c2ws_input"], batch["fxfycxcys_input"],
                            RES_512, RES_512)
    inputs = (batch["rgbs_input"], ray_o, ray_d,
              torch.tensor([500], device=dev))
    ref = f32 = None
    if mesh.rank == 0:
        ref = par_reference(torch, dev, CONFIG_512, batch, inputs)
        f32 = par_reference(torch, dev, CONFIG_512, batch, f32=True,
                            steps=1)
    mesh.barrier()
    cfg, system, state, step_fn = par_setup(torch, dev, CONFIG_512, mesh)
    n_layers = len(system.model.transformer)
    res = {"n_layers": n_layers}
    reset_launches(attention)
    with torch.no_grad():
        dit = dit_output(torch, system, inputs)
    res["sampler_launches"] = launch_counts(attention)
    if ref is not None:
        res["dit_rel_max"] = rel_max(dit, ref["dit"])
        res["dit_bit_equal_fraction"] = float((dit == ref["dit"]).double()
                                              .mean())
    del dit

    def first(st):
        res["step_launches"] = launch_counts(attention)
        avg = averaged_grads(mesh, st.params)
        if ref is not None:
            mine = par_compare(torch, f32, st.params, avg)
            one = par_compare(torch, f32, ref["p1"], ref["grads"])
            res["vs_one_process"] = summary(
                par_compare(torch, ref, st.params, avg))
            res["vs_f32"], res["one_process_vs_f32"] = summary(mine), \
                summary(one)
            res["excess_over_one_process_vs_f32"] = excess_error(mine, one)
            res["same_init_as_f32"] = all(
                torch.equal(ref["p0"][k], v) for k, v in f32["p0"].items())
    reset_launches(attention)
    res["sp_steps"] = par_steps(torch, state, step_fn, batch, 2, first)
    if ref is not None:
        res["one_process_steps"] = ref["steps"]
        res["f32_steps"] = f32["steps"]
    want_step = {"LAUNCHES_STATS": n_layers * 2 * mesh.sp,
                 "LAUNCHES_BWD": n_layers * mesh.sp}
    res["expected_step_launches"] = want_step
    res["expected_sampler_launches"] = {"LAUNCHES_STATS": n_layers * mesh.sp}
    del system, state, step_fn, ref, f32
    collect_garbage()
    torch.cuda.empty_cache()
    return res


def par_launch(torch, mesh, tmp, data, images, init) -> dict:
    """17b iv: `launch --train` on the two ranks (ZeRO-1, b = 1 a data
    rank, 2 steps); rank 1 records every file it would write."""
    import builtins

    from open_diffusiongs_tpu_torch import launch
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    rank = mesh.rank
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2")
    argv = ["--config", CONFIG, "--device", "cuda", "--dist-backend",
            "gloo", "--dist-init", init, "--train", "--max_steps", "2",
            f"exp_root_dir={tmp}/outputs", f"data.local_dir={data}",
            f"data.image_dir={images}/", "use_timestamp=false",
            "system.use_lpips=false", "trainer.eval_every_n_steps=0",
            "checkpoint.every_n_train_steps=1000000", "data.batch_size=1",
            "trainer.zero1=true", "trainer.log_every_n_steps=1"]
    writes = []
    real = (builtins.open, torch.save, os.makedirs, os.replace)
    if rank == 1:
        def rec_open(path, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                writes.append(str(path))
            return real[0](path, mode, *a, **k)

        def rec(fn):
            def wrapped(path, *a, **k):
                writes.append(str(path))
                return fn(path, *a, **k)
            return wrapped

        def rec_save(obj, f, *a, **k):
            writes.append(str(f))
            return real[1](obj, f, *a, **k)
        builtins.open, torch.save = rec_open, rec_save
        os.makedirs, os.replace = rec(real[2]), rec(real[3])
    reset_launches(attention, blend_kernel)
    try:
        t0 = time.perf_counter()
        record = launch.main(argv)
        secs = time.perf_counter() - t0
    finally:
        builtins.open, torch.save, os.makedirs, os.replace = real
    state = record["state"]
    ema = state.full_ema()          # collectives: both ranks
    mu = state.optimizer.state_dict()["mu"]
    out = {"writes": writes, "trial_dir": record["trial_dir"],
           "step": state.step, "seconds": secs,
           "stages": dict(record["seconds"]),
           "launches": {f"{m.__name__.rsplit('.', 1)[1]}.{n}": v
                        for m in (attention, blend_kernel)
                        for n, v in launch_counts(m).items()}}
    if rank == 0:
        torch.save({"param": state.params[RESTORE_CHECK].detach().cpu(),
                    "ema": ema[RESTORE_CHECK].cpu(),
                    "adam_mu": mu[RESTORE_CHECK].cpu()},
                   os.path.join(tmp, "launch_spot.pt"))
    del record, state, ema, mu
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def parallel_rank(rank: int, init: str, tmp: str, data: str,
                  images: str) -> None:
    """One of phase 17b's two ranks (a spawned process sharing card 0):
    its results go to <tmp>/rank<rank>.json, a failure's traceback too."""
    import traceback

    import torch
    sys.path.insert(0, ROOT)
    out = {}
    try:
        from open_diffusiongs_tpu_torch.parallel import mesh as mesh_lib
        dev = torch.device("cuda", 0)
        kw = dict(device_type="cuda", backend="gloo", init_method=init,
                  rank=rank, world_size=2, local_rank=rank, local_world=2)
        mesh = mesh_lib.init_mesh(seq_parallel=1, **kw)
        out["dp"] = par_dp_zero1(torch, dev, mesh)
        mesh = mesh_lib.init_mesh(seq_parallel=2, **kw)
        out["sp"] = par_seq(torch, dev, mesh)
        out["launch"] = par_launch(torch, mesh, tmp, data, images, init)
        out["staged_ring_shifts"] = mesh_lib.STAGED
        mesh.barrier()
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


def phase_parallel(torch, dev, tmp: str) -> dict:
    """17b: two ranks on the one card over gloo (module docstring)."""
    import torch.multiprocessing as mp

    from open_diffusiongs_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer)
    from open_diffusiongs_tpu_torch.systems.builder import (
        build_optimizer_config, build_system)
    from open_diffusiongs_tpu_torch.utils.checkpoint import CheckpointManager
    from open_diffusiongs_tpu_torch.utils.config import load_config
    data, images, _ = write_gobjaverse_tree(os.path.join(tmp, "tree"), 2,
                                            OBJECT_VIEWS, OBJECT_RES)
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, init, tmp, data, images)) for r in (0, 1)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    while (any(p.is_alive() for p in procs)
           and not any(p.exitcode for p in procs)
           and time.perf_counter() - t0 < PAR_TIMEOUT):
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    world_s = time.perf_counter() - t0
    outs = []
    for r in (0, 1):
        path = os.path.join(tmp, f"rank{r}.json")
        outs.append(json.load(open(path)) if os.path.exists(path) else {})
    errors = [o.get("error") for o in outs if o.get("error")]
    if errors or any(p.exitcode for p in procs) or not all(outs):
        raise AssertionError(f"17b: a rank failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(errors))
    dp, sp, ln = (outs[0][k] for k in ("dp", "sp", "launch"))
    # one process restores the two-rank run's checkpoint
    cfg = load_config(CONFIG, cli_args=["system.use_lpips=false"],
                      makedirs=False)
    system = build_system(cfg.system_type, cfg.system, device=dev)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    params = dict(system.model.named_parameters())
    state = init_train_state(params, make_optimizer(
        build_optimizer_config(cfg.system, cfg.trainer), params.items()),
        ema_decay=0.9999)
    ckpts = os.path.join(ln["trial_dir"], "ckpts")
    t1 = time.perf_counter()
    CheckpointManager(ckpts).restore(state)
    restore_s = time.perf_counter() - t1
    spot = torch.load(os.path.join(tmp, "launch_spot.pt"))
    restored = {"param": state.params[RESTORE_CHECK],
                "ema": state.ema_params[RESTORE_CHECK],
                "adam_mu": state.optimizer.state_dict()["mu"][RESTORE_CHECK]}
    restored_equal = {k: bool(torch.equal(v.detach().cpu(), spot[k]))
                      for k, v in restored.items()}
    del system, state, params, restored
    collect_garbage()
    torch.cuda.empty_cache()
    trial_files = sorted(os.listdir(ln["trial_dir"]))

    def per_step(steps):
        return steps[-1]["seconds"]
    dp["peak_device_bytes_per_rank"] = [o["dp"]["peak_device_bytes"]
                                        for o in outs]
    res = {"dp2": dp, "sp2": sp,
           "launch": {**ln, "rank1_writes": outs[1]["launch"]["writes"],
                      "trial_files": trial_files,
                      "ckpts": sorted(os.listdir(ckpts)),
                      "restore_seconds": restore_s,
                      "restored_equal": restored_equal},
           "staged_ring_shifts": [o["staged_ring_shifts"] for o in outs],
           "seconds_per_step": {
               "note": "two processes sharing one card through gloo "
                       "(host-staged transfers), not a scaling figure",
               "256^2 one process b=4": per_step(dp["one_process_steps"]),
               "256^2 dp=2 b=2 a rank": per_step(dp["ddp_steps"]),
               "256^2 dp=2 zero1": per_step(dp["zero1_steps"]),
               "512^2 one process b=1": per_step(sp["one_process_steps"]),
               "512^2 sp=2 b=1": per_step(sp["sp_steps"])},
           "world_seconds": world_s, "card": card_line()}
    print(f"[17b parallel] {json.dumps(res)}", flush=True)
    print(f"[17b parallel] ring transport: "
          f"{res['staged_ring_shifts']} neighbour shifts per rank staged "
          f"through pinned host buffers (gloo's send / recv take host "
          f"memory only)", flush=True)
    par_gates(dp, sp, res["launch"])
    return res


def par_gates(dp: dict, sp: dict, ln: dict) -> None:
    one = dp["one_process_steps"][0]
    checks = [
        ("dp=2 loss", abs(dp["ddp_loss_mean"][0] - one["loss"])
         / abs(one["loss"]), PAR_LOSS_REL),
        ("dp=2 grad_norm", abs(dp["ddp_steps"][0]["grad_norm"]
                               - one["grad_norm"]) / one["grad_norm"],
         PAR_REL),
        ("dp=2 averaged gradients rel-max",
         dp["vs_one_process"]["grad_rel_max"], PAR_REL),
        ("dp=2 update rel-max", dp["vs_one_process"]["update_rel_max"],
         PAR_REL)]
    one = sp["one_process_steps"][0]
    checks += [
        ("sp=2 loss", abs(sp["sp_steps"][0]["loss"] - one["loss"])
         / abs(one["loss"]), PAR_LOSS_REL),
        ("sp=2 grad_norm", abs(sp["sp_steps"][0]["grad_norm"]
                               - one["grad_norm"]) / one["grad_norm"],
         PAR_REL),
        ("sp=2 DiT output rel-max", sp["dit_rel_max"], PAR_REL)]
    # Tensor by tensor against the f32 reference (the model computing in
    # f32, its attention by SDPA): one process's bf16 step is itself
    # ~1e-1 from it in the tensors whose sums over 16386 tokens cancel
    # (the tokenizer's weight, fc2 and adaLN of single blocks), so the two
    # bf16 steps cannot be held to 1e-2 of each other there; the ranks'
    # step is held to lie no further from the f32 step than one process
    # does, beyond the 1e-2 bar (worst tensor, gradients and update)
    mine, one32 = sp["vs_f32"], sp["one_process_vs_f32"]
    checks += [
        (f"sp=2 {what} vs f32, beyond one process's",
         mine[key] - one32[key], PAR_REL)
        for what, key in (("averaged gradients rel-max", "grad_rel_max"),
                          ("gradients rel-L2", "grad_rel_l2_max"),
                          ("update rel-max", "update_rel_max"))]
    if not sp["same_init_as_f32"]:
        raise AssertionError("17b: the f32 reference starts from other "
                             "params")
    for what, val, bar in checks:
        if not val <= bar:
            raise AssertionError(f"17b {what} {val:.3g} > {bar}")
    if any(dp["zero1_vs_ddp_differing_tensors"].values()) or not all(
            dp["zero1_vs_ddp_grad_norm_equal"]):
        raise AssertionError(f"17b ZeRO-1 differs from DDP: "
                             f"{dp['zero1_vs_ddp_differing_tensors']}")
    for key in ("step_launches", "sampler_launches"):
        want = sp[f"expected_{key}"]
        got = {k: v for k, v in sp[key].items() if v}
        if got != want:
            raise AssertionError(f"17b sp=2 {key} {got} != {want}")
    if ln["rank1_writes"]:
        raise AssertionError(f"17b launch: rank 1 wrote "
                             f"{ln['rank1_writes'][:5]}")
    if ln["step"] != 2 or ln["ckpts"] != ["2.pt"] or not {
            "cmd.txt", "parsed.yaml", "metrics.csv"} <= set(ln["trial_files"]):
        raise AssertionError(f"17b launch: step {ln['step']}, ckpts "
                             f"{ln['ckpts']}, files {ln['trial_files']}")
    if not all(ln["restored_equal"].values()):
        raise AssertionError(f"17b launch: the checkpoint did not restore "
                             f"bit for bit on one process: "
                             f"{ln['restored_equal']}")


# phase 18: tensor and pipeline parallelism and serving over data ranks
PAR18_LOSS_REL = 1e-4        # the tp / pp step's loss against one process
SERVE_PSNR_DB = 50.0         # each served element's renders, dp = 2 vs one
SERVE_IMAGES = (IMAGE, os.path.join(ROOT, "extra_files", "test_cases",
                                    "torus.png"))
PAR18_TIMEOUT = 420


def par_whole(mesh, named: dict) -> dict:
    """Every rank's part of `named` put together into whole tensors by
    the reference's names (parallel/shard.py: a collective)."""
    from open_diffusiongs_tpu_torch.parallel.shard import gather_state_dict
    return gather_state_dict({k: v.detach() for k, v in named.items()}, mesh)


def par_sharded_step(torch, dev, mesh, ref, f32, batch) -> dict:
    """18 i-ii: two steps of a tp = 2 or pp = 2 world on the whole batch
    from the one-process init and draws; the first step's gradients and
    update (every rank's part put together) against the one-process step
    and the f32 step; launches, sums over `model` and bytes per rank."""
    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.parallel import tensor_parallel
    _, system, state, step_fn = par_setup(torch, dev, CONFIG, mesh)
    stack = system.model.transformer
    res = {"layers_per_rank": len(stack),
           "heads_per_rank": sorted({b.attn.num_heads for b in stack}),
           "packed": all(b.attn.packed for b in stack),
           "param_bytes_per_rank": 4 * sum(p.numel() for p in
                                           state.params.values())}

    def first(st):
        res["step_launches"] = {
            f"{m.__name__.rsplit('.', 1)[1]}.{n}": v
            for m in (attention, blend_kernel)
            for n, v in launch_counts(m).items() if v}
        res["model_sum_bytes"] = tensor_parallel.BYTES
        grads = par_whole(mesh, {k: p.grad for k, p in st.params.items()})
        params = par_whole(mesh, st.params)
        if ref is not None:
            mine = par_compare(torch, f32, params, grads)
            one = par_compare(torch, f32, ref["p1"], ref["grads"])
            res["vs_one_process"] = summary(par_compare(torch, ref, params,
                                                        grads))
            res["vs_f32"], res["one_process_vs_f32"] = summary(mine), \
                summary(one)
            res["excess_over_one_process_vs_f32"] = excess_error(mine, one)
        del grads, params
        collect_garbage()
        torch.cuda.empty_cache()
    reset_launches(attention, blend_kernel)
    tensor_parallel.BYTES = 0
    res["steps"] = par_steps(torch, state, step_fn, batch, 2, first)
    mu = state.optimizer.state_dict()["mu"]
    res["adam_moment_bytes_per_rank"] = 2 * 4 * sum(v.numel()
                                                    for v in mu.values())
    mb = 2 if mesh.pp > 1 else 1          # GPipe's microbatches
    res["expected_step_launches"] = {
        "attention.LAUNCHES_STATS": 2 * len(stack) * mb,
        "attention.LAUNCHES_BWD": len(stack) * mb}
    # block checkpointing: each layer's proj and fc2 sums twice forward,
    # its qkv and fc1 input sums once backward, each a [b, L, d] bf16
    d = system.model.width
    res["expected_model_sum_bytes"] = (
        0 if mesh.tp == 1 else
        6 * len(stack) * TRAIN_BATCH * (2 + N_VIEWS * (RES // 8) ** 2)
        * d * 2)
    del system, state, step_fn, mu
    collect_garbage()
    torch.cuda.empty_cache()
    return res


def par_serve(torch, dev, mesh) -> dict:
    """18 iii: `DiffusionGSPipeline.batch` of two images over dp = 2 data
    ranks against the one-process batch of both (rank 0 runs it first)."""
    import numpy as np

    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    from open_diffusiongs_tpu_torch.systems.builder import build_system
    from open_diffusiongs_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, makedirs=False)
    system = build_system(cfg.system_type, cfg.system, device=dev, mesh=mesh)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    pipe = DiffusionGSPipeline(system)
    kw = dict(resolution=RES, n_views=N_VIEWS, matting="border", seed=0)
    ref = (pipe.batch(list(SERVE_IMAGES), **kw) if mesh.rank == 0
           else None)
    mesh.barrier()
    pipe.batch(list(SERVE_IMAGES), mesh=mesh, **kw)          # warm-up
    reset_launches(attention, blend_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = pipe.batch(list(SERVE_IMAGES), mesh=mesh, **kw)
    torch.cuda.synchronize()
    res = {"seconds_per_bundle": time.perf_counter() - t0,
           "launches_per_rank": {
               "attention": attention.LAUNCHES,
               "blend": blend_kernel.LAUNCHES},
           "expected_launches_per_rank": {
               "attention": len(system.model.transformer) * STEPS,
               "blend": (STEPS - 1) * (N_VIEWS - 1) + N_VIEWS},
           "elements": len(outs),
           "render_sums": [float(np.sum(o.renders, dtype=np.float64))
                           for o in outs]}
    for o in outs:
        check_asset(o, RES)
    if ref is not None:
        res["psnr_db"] = [psnr(o.renders, r.renders)
                          for o, r in zip(outs, ref)]
        res["xyz_rel_max"] = [
            float(np.abs(o.gaussians.xyz - r.gaussians.xyz).max()
                  / np.abs(r.gaussians.xyz).max()) for o, r in zip(outs, ref)]
        res["renders_bit_equal_fraction"] = [
            float(np.mean(o.renders == r.renders)) for o, r in zip(outs, ref)]
    del system, pipe, outs, ref
    collect_garbage()
    torch.cuda.empty_cache()
    return res


def parallel18_rank(rank: int, init: str, tmp: str) -> None:
    """One of phase 18's two ranks (a spawned process sharing card 0):
    its results go to <tmp>/rank<rank>.json, a failure's traceback too."""
    import traceback

    import torch
    sys.path.insert(0, ROOT)
    out = {}
    try:
        from open_diffusiongs_tpu_torch.parallel import mesh as mesh_lib
        dev = torch.device("cuda", 0)
        kw = dict(device_type="cuda", backend="gloo", init_method=init,
                  rank=rank, world_size=2, local_rank=rank, local_world=2)
        batch = train_batch(torch, dev, TRAIN_BATCH, RES)
        ref = f32 = None
        if rank == 0:
            ref = par_reference(torch, dev, CONFIG, batch)
            f32 = par_reference(torch, dev, CONFIG, batch, f32=True,
                                steps=1)
            out["one_process_steps"] = ref["steps"]
            out["f32_steps"] = f32["steps"]
        mesh = mesh_lib.init_mesh(model_parallel=2, **kw)
        mesh.barrier()
        out["tp2"] = par_sharded_step(torch, dev, mesh, ref, f32, batch)
        mesh = mesh_lib.init_mesh(pipe_parallel=2, **kw)
        out["pp2"] = par_sharded_step(torch, dev, mesh, ref, f32, batch)
        del ref, f32
        collect_garbage()
        torch.cuda.empty_cache()
        out["dp2_serving"] = par_serve(torch, dev, mesh_lib.init_mesh(**kw))
        out["staged_transfers"] = mesh_lib.STAGED
        mesh.barrier()
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


def phase_parallel18(torch, dev, tmp: str) -> dict:
    """18: two ranks on the one card over gloo: tp = 2 and pp = 2 train
    steps and dp = 2 serving (module docstring)."""
    import torch.multiprocessing as mp
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=parallel18_rank, args=(r, init, tmp))
             for r in (0, 1)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    while (any(p.is_alive() for p in procs)
           and not any(p.exitcode for p in procs)
           and time.perf_counter() - t0 < PAR18_TIMEOUT):
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    world_s = time.perf_counter() - t0
    outs = []
    for r in (0, 1):
        path = os.path.join(tmp, f"rank{r}.json")
        outs.append(json.load(open(path)) if os.path.exists(path) else {})
    errors = [o.get("error") for o in outs if o.get("error")]
    if errors or any(p.exitcode for p in procs) or not all(outs):
        raise AssertionError(f"18: a rank failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(errors))
    o0 = outs[0]
    res = {"tp2": o0["tp2"], "pp2": o0["pp2"],
           "dp2_serving": [o["dp2_serving"] for o in outs],
           "staged_transfers": [o["staged_transfers"] for o in outs],
           "seconds_per_step": {
               "note": "two processes sharing one card through gloo "
                       "(host-staged transfers), not a scaling figure",
               "256^2 one process b=4": o0["one_process_steps"][-1]
               ["seconds"],
               "256^2 tp=2 b=4": o0["tp2"]["steps"][-1]["seconds"],
               "256^2 pp=2 b=4 (2 microbatches)":
                   o0["pp2"]["steps"][-1]["seconds"],
               "256^2 dp=2 serving, 2 images (s a bundle)":
                   o0["dp2_serving"]["seconds_per_bundle"]},
           "one_process_steps": o0["one_process_steps"],
           "world_seconds": world_s, "card": card_line()}
    print(f"[18 parallel] {json.dumps(res)}", flush=True)
    par18_gates(res, outs)
    return res


def par18_gates(res: dict, outs: list) -> None:
    one = res["one_process_steps"][0]
    checks = []
    for key in ("tp2", "pp2"):
        r = res[key]
        checks.append((f"{key} loss", abs(r["steps"][0]["loss"]
                                          - one["loss"]) / abs(one["loss"]),
                       PAR18_LOSS_REL))
        mine, one32 = r["vs_f32"], r["one_process_vs_f32"]
        checks += [(f"{key} {what} vs f32, beyond one process's",
                    mine[k] - one32[k], PAR_REL)
                   for what, k in (("gradients rel-max", "grad_rel_max"),
                                   ("gradients rel-L2", "grad_rel_l2_max"),
                                   ("update rel-max", "update_rel_max"))]
        launches = {k: v for k, v in r["step_launches"].items()
                    if k.startswith("attention.")}
        if launches != r["expected_step_launches"]:
            raise AssertionError(f"18 {key} launches {launches} != "
                                 f"{r['expected_step_launches']}")
        if r["model_sum_bytes"] != r["expected_model_sum_bytes"]:
            raise AssertionError(f"18 {key} bytes summed over model "
                                 f"{r['model_sum_bytes']} != "
                                 f"{r['expected_model_sum_bytes']}")
    if res["tp2"]["heads_per_rank"] != [8] or not res["tp2"]["packed"]:
        raise AssertionError(f"18 tp2: heads {res['tp2']['heads_per_rank']}"
                             f", packed {res['tp2']['packed']}")
    if res["pp2"]["layers_per_rank"] != 12:
        raise AssertionError(f"18 pp2: {res['pp2']['layers_per_rank']} "
                             f"layers a stage")
    serve = res["dp2_serving"]
    checks += [(f"dp2 serving element {i} PSNR (dB, at least)", -db,
                -SERVE_PSNR_DB) for i, db in enumerate(serve[0]["psnr_db"])]
    for what, val, bar in checks:
        if not val <= bar:
            raise AssertionError(f"18 {what} {val:.4g} > {bar}")
    for s in serve:
        if s["elements"] != len(SERVE_IMAGES) or \
                s["launches_per_rank"] != s["expected_launches_per_rank"]:
            raise AssertionError(f"18 dp2 serving: {s['elements']} "
                                 f"elements, launches "
                                 f"{s['launches_per_rank']}")
    if serve[0]["render_sums"] != serve[1]["render_sums"]:
        raise AssertionError("18 dp2 serving: the ranks returned different "
                             "lists")


SYNTH_ABS_BOUND = BLEND_ABS_BOUND   # card vs CPU renders, the raster bar
SYNTH_DEPTH_ALPHA = 0.3             # depth compared where both alphas pass
SYNTH_SMALL = {"res": 64, "gaussians": 256, "frames": 5, "wall_step": 0.5,
               "lobes": 4}
SYNTH_FULL = {"objects": 2, "scenes": 1, "frames": 48, "res": 256}
# 19a at full size, where the object's capacities clip: 4 of an object's
# 40 views (both rings, the lower aux view, the top) and the first chunk
# of 8 frames of 19b's room (seed 0), card against CPU
SYNTH_CLIP_VIEWS = (0, 8, 28, 39)
# a pixel is apart when any compared value differs by more than the raster
# bar; at full size a few pixels hold a Gaussian whose alpha sits on the
# blend's 1/255 skip (or a transmittance on its 1e-4 stop), which f32
# rounding flips: each apart pixel must agree once the CPU's threshold
# moves by 0.1 % (SYNTH_FLIP_MOVES), and at most SYNTH_FLIP_SHARE of the
# pixels may be apart (a 0.1 % threshold move itself flips 0.2-0.3 % of
# them on these inputs)
SYNTH_FLIP_MOVES = (("ALPHA_MIN", 1.001), ("ALPHA_MIN", 0.999),
                    ("EARLY_STOP_T", 1.001), ("EARLY_STOP_T", 0.999))
SYNTH_FLIP_SHARE = 1e-3
SYNTH_STEPS, SYNTH_EVAL_EVERY = 20, 10
# after tools/train_protocol.py's PROTOCOL (docs/CONVERGENCE.md's b = 1,
# LPIPS off, lr 5e-5): an eval every SYNTH_EVAL_EVERY steps, the final
# save only
SYNTH_OVERRIDES = [f"trainer.eval_every_n_steps={SYNTH_EVAL_EVERY}",
                   "use_timestamp=false",
                   "checkpoint.every_n_train_steps=1000000"]


def png_bytes(rgb, alpha=None):
    """The uint8 image the generators write: (rgb[a] * 255) truncated."""
    import numpy as np
    img = rgb if alpha is None else np.concatenate([rgb, alpha[..., None]],
                                                   axis=-1)
    return (img * 255).astype(np.uint8).astype(np.int16)


def synth_card_vs_cpu(torch, dev) -> dict:
    """19a: both generators' renders at a small size on the card and on
    the CPU, the card's blend launches per object / scene."""
    import numpy as np

    from open_diffusiongs_tpu_torch.ops import blend_kernel
    from open_diffusiongs_tpu_torch.tools import make_synthetic_objaverse as mo
    from open_diffusiongs_tpu_torch.tools import make_synthetic_re10k as mr
    s = SYNTH_SMALL
    out = {}

    def on_card(fn, *args):
        reset_launches(blend_kernel)
        got = fn(*args, dev)
        torch.cuda.synchronize()
        return got, blend_kernel.LAUNCHES

    gauss = mo.make_scene(np.random.default_rng(0), s["gaussians"])
    card, launches = on_card(mo.render_object, gauss, s["res"])
    cpu = mo.render_object(gauss, s["res"], "cpu")
    (rgb, alpha, depth, _, cnt), (rgb_c, alpha_c, depth_c, _, cnt_c) = \
        card, cpu
    both = (alpha > SYNTH_DEPTH_ALPHA) & (alpha_c > SYNTH_DEPTH_ALPHA)
    out["object"] = {
        "alpha_max_abs_err": float(np.abs(alpha - alpha_c).max()),
        "rgb_times_alpha_max_abs_err": float(np.abs(
            rgb * alpha[..., None] - rgb_c * alpha_c[..., None]).max()),
        "rgb_max_abs_err_alpha_gt_0.3": float(np.abs(rgb - rgb_c)[both]
                                              .max()),
        "depth_max_abs_err_alpha_gt_0.3": float(np.abs(depth - depth_c)[both]
                                                .max()),
        "png_max_lsb": int(np.abs(png_bytes(rgb, alpha)
                                  - png_bytes(rgb_c, alpha_c)).max()),
        "counters": cnt, "counters_cpu": cnt_c,
        "blend_launches_per_object": launches}
    rng = np.random.default_rng(0)
    room = mr.make_room(rng, step=s["wall_step"], n_lobes=s["lobes"])
    c2ws = mr.trajectory(rng, s["frames"])
    (rgb, cnt), launches = on_card(mr.render_scene, room, c2ws, s["res"])
    rgb_c, cnt_c = mr.render_scene(room, c2ws, s["res"], "cpu")
    out["scene"] = {
        "n_gauss": int(room.xyz.shape[1]),
        "rgb_max_abs_err": float(np.abs(rgb - rgb_c).max()),
        "png_max_lsb": int(np.abs(png_bytes(rgb) - png_bytes(rgb_c)).max()),
        "counters": cnt, "counters_cpu": cnt_c,
        "blend_launches_per_scene": launches}
    return out


def object_apart(got, ref):
    """[V, h, w] bool: the pixels where two object renders ((rgb, alpha,
    depth, ...) as `render_object` returns them) differ by more than the
    raster bar in alpha or rgb x alpha, or, where both alphas > 0.3, in
    rgb or depth."""
    import numpy as np
    (rgb, alpha, depth), (rgb_r, alpha_r, depth_r) = got[:3], ref[:3]
    bar = SYNTH_ABS_BOUND
    both = (alpha > SYNTH_DEPTH_ALPHA) & (alpha_r > SYNTH_DEPTH_ALPHA)
    return ((np.abs(alpha - alpha_r) > bar)
            | (np.abs(rgb * alpha[..., None] - rgb_r * alpha_r[..., None])
               > bar).any(-1)
            | both & ((np.abs(rgb - rgb_r) > bar).any(-1)
                      | (np.abs(depth - depth_r) > bar)))


def scene_apart(got, ref):
    """[F, h, w] bool: the pixels where two scene renders ((rgb, counters)
    as `render_scene` returns them) differ by more than the raster bar."""
    import numpy as np
    return (np.abs(got[0] - ref[0]) > SYNTH_ABS_BOUND).any(-1)


def unexplained_flips(apart, rerender, apart_fn, ref):
    """The pixels of `apart` that no threshold move explains: `rerender()`
    (the CPU render) is re-made with the blend's skip or stop threshold
    moved as SYNTH_FLIP_MOVES say, and a pixel is explained once one such
    render agrees with `ref` (the card's) there."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel
    left = apart.copy()
    for name, scale in SYNTH_FLIP_MOVES:
        if not left.any():
            break
        keep = getattr(blend_kernel, name)
        setattr(blend_kernel, name, keep * scale)
        try:
            got = rerender()
        finally:
            setattr(blend_kernel, name, keep)
        left &= apart_fn(got, ref)
    return left


def synth_clipped_card_vs_cpu(torch, dev) -> dict:
    """19a at full size: SYNTH_CLIP_VIEWS of a 4,096-Gaussian object at
    256^2 (D = 16, K = 512, where both counters read nonzero) and the first
    8-frame chunk of 19b's room (D = 256, K = 4096) on the card and the CPU;
    the apart pixels (`object_apart`, `scene_apart`), those no threshold
    flip explains, the counters and the card's blend launches."""
    import numpy as np

    from open_diffusiongs_tpu_torch.ops import blend_kernel
    from open_diffusiongs_tpu_torch.tools import make_synthetic_objaverse as mo
    from open_diffusiongs_tpu_torch.tools import make_synthetic_re10k as mr
    res = SYNTH_FULL["res"]
    gauss = mo.make_scene(np.random.default_rng(0), 4096)
    rng = np.random.default_rng(0)            # 19b's first room
    room = mr.make_room(rng)
    c2ws = mr.trajectory(rng, SYNTH_FULL["frames"])[:mr.CHUNK_VIEWS]
    # (render, apart_fn, where the counters are, the value whose largest
    # error is printed: alpha for the object, rgb for the scene)
    cases = {
        "object": (lambda d: mo.render_object(gauss, res, d,
                                              views=SYNTH_CLIP_VIEWS),
                   object_apart, 4, 1),
        "scene": (lambda d: mr.render_scene(room, c2ws, res, d),
                  scene_apart, 1, 0)}
    out = {}
    for key, (render, apart_fn, at, val) in cases.items():
        reset_launches(blend_kernel)
        card = render(dev)
        torch.cuda.synchronize()
        launches = blend_kernel.LAUNCHES
        cpu = render("cpu")
        apart = apart_fn(cpu, card)
        left = unexplained_flips(apart, lambda: render("cpu"), apart_fn,
                                 card)
        err = np.abs(cpu[val] - card[val]).reshape(apart.shape + (-1,)
                                                   ).max(-1)
        name = ("alpha", "rgb")[val == 0]
        out[key] = {"pixels": int(apart.size),
                    "apart_pixels": int(apart.sum()),
                    "apart_share": float(apart.mean()),
                    "unexplained_pixels": int(left.sum()),
                    f"{name}_max_abs_err": float(err.max()),
                    f"{name}_max_abs_err_not_apart": float(err[~apart].max()),
                    "counters": card[at], "counters_cpu": cpu[at],
                    "blend_launches": launches}
    out["scene"]["n_gauss"] = int(room.xyz.shape[1])
    return out


def synth_launch(torch, dev, recipe: str, tree: str, tmp: str) -> dict:
    """19b: `launch --train` for SYNTH_STEPS steps on a generated tree with
    the recipe's config and the protocol's overrides; its metrics, eval
    rows, launches and peak."""
    import numpy as np

    from open_diffusiongs_tpu_torch.ops import attention, blend_kernel
    from open_diffusiongs_tpu_torch.tools.train_protocol import (PROTOCOL,
                                                                 RECIPES)
    from open_diffusiongs_tpu_torch.utils.config import load_config
    config, data = RECIPES[recipe]
    config = os.path.join(ROOT, config)
    name = f"synth_{recipe}"
    overrides = [f"exp_root_dir={tmp}/outputs", f"name={name}", *data(tree),
                 *PROTOCOL, *SYNTH_OVERRIDES]
    cfg = load_config(config, cli_args=overrides, makedirs=False)
    views = (int(cfg.data["gen_views"]) + int(cfg.data["sel_views"])
             if "gen_views" in cfg.data else
             int(cfg.data["sel_views"]) + int(cfg.data["sel_views_train"]))
    record, counts, call = launch_call(torch, dev, [
        "--config", config, "--train", "--device", dev.type, "--max_steps",
        str(SYNTH_STEPS), *overrides], (attention, blend_kernel))
    trial = record["trial_dir"]
    drop_record(torch, record)
    rows = read_csv(os.path.join(trial, "metrics.csv"))
    evals = read_csv(os.path.join(trial, "eval_metrics.csv"))
    col = {k: rows[0].index(k) for k in rows[0]}
    ecol = {k: evals[0].index(k) for k in evals[0]}
    n_evals = SYNTH_STEPS // SYNTH_EVAL_EVERY + 1
    out = {"config": os.path.relpath(config, ROOT), "views_per_step": views,
           "losses": [float(r[col["loss"]]) for r in rows[1:]],
           "seconds_per_step": [1.0 / float(r[col["steps_per_sec"]])
                                for r in rows[1:]],
           "eval_steps": [int(r[0]) for r in evals[1:]],
           "eval_psnr": [float(r[ecol["psnr"]]) for r in evals[1:]],
           "overflow": {k: [float(r[col[k]]) for r in rows[1:]]
                        for k in ("overflow_tiles", "overflow_gaussians",
                                  "overflow_frac")},
           "launches": counts,
           "expected_launches": expected_counts(
               steps=SYNTH_STEPS, evals=n_evals, views=views),
           "call": call}
    if not all(np.isfinite(float(x)) for r in rows[1:] + evals[1:]
               for x in r[1:]):
        raise AssertionError(f"19b {name}: non-finite metrics")
    if out["eval_steps"] != list(range(0, SYNTH_STEPS + 1,
                                       SYNTH_EVAL_EVERY)):
        raise AssertionError(f"19b {name}: eval rows {out['eval_steps']}")
    if counts != out["expected_launches"]:
        raise AssertionError(f"19b {name}: launches {counts} != "
                             f"{out['expected_launches']}")
    return out


def phase_synthetic(torch, dev, tmp: str) -> dict:
    """19: the port's synthetic G-Objaverse and RE10K generators on the
    card against the CPU at a small size (19a), then their trees at full
    size on the card and 20 steps of `launch --train` on each with its
    recipe (19b; module docstring)."""
    from open_diffusiongs_tpu_torch.ops import blend_kernel
    from open_diffusiongs_tpu_torch.tools import make_synthetic_objaverse as mo
    from open_diffusiongs_tpu_torch.tools import make_synthetic_re10k as mr
    small = synth_card_vs_cpu(torch, dev)
    clipped = synth_clipped_card_vs_cpu(torch, dev)
    f = SYNTH_FULL
    obja, re10k = os.path.join(tmp, "obja"), os.path.join(tmp, "re10k")
    gen = {}
    for key, tool, argv in (
            ("objects", mo, ["--device", dev.type, "--out", obja,
                             "--objects", str(f["objects"]),
                             "--res", str(f["res"])]),
            ("scenes", mr, ["--device", dev.type, "--out", re10k,
                            "--scenes", str(f["scenes"]),
                            "--frames", str(f["frames"]),
                            "--res", str(f["res"])])):
        reset_launches(blend_kernel)
        t0 = time.perf_counter()
        summary = tool.main(argv)
        gen[key] = {"seconds": time.perf_counter() - t0,
                    "per_item": summary.get("per_object",
                                            summary.get("per_scene")),
                    "blend_launches": blend_kernel.LAUNCHES}
    collect_garbage()
    torch.cuda.empty_cache()
    train = {"object": synth_launch(torch, dev, "object", obja, tmp),
             "scene": synth_launch(torch, dev, "scene", re10k, tmp)}
    out = {"card_vs_cpu": small, "card_vs_cpu_full_size": clipped,
           "generate": gen, "train": train,
           "sizes": {"small": SYNTH_SMALL, "full": SYNTH_FULL},
           "card": card_line()}
    out["launches"] = {k: sum(t["launches"][k] for t in train.values())
                       for k in train["object"]["launches"]}
    out["launches"]["blend_kernel.LAUNCHES"] += sum(
        g["blend_launches"] for g in gen.values()) + \
        small["object"]["blend_launches_per_object"] + \
        small["scene"]["blend_launches_per_scene"] + \
        sum(c["blend_launches"] for c in clipped.values())
    print(f"[19 synthetic trees] {json.dumps(out)}", flush=True)
    o, s = small["object"], small["scene"]
    checks = [(f"19a object {k}", o[k], SYNTH_ABS_BOUND)
              for k in ("alpha_max_abs_err", "rgb_times_alpha_max_abs_err",
                        "rgb_max_abs_err_alpha_gt_0.3",
                        "depth_max_abs_err_alpha_gt_0.3")]
    checks += [("19a scene rgb_max_abs_err", s["rgb_max_abs_err"],
                SYNTH_ABS_BOUND),
               ("19a object png_max_lsb", o["png_max_lsb"], 1),
               ("19a scene png_max_lsb", s["png_max_lsb"], 1)]
    for what, val, bar in checks:
        if not val <= bar:
            raise AssertionError(f"{what} {val:.4g} > {bar}")
    for k, r in (("object", o), ("scene", s)):
        if r["counters"] != r["counters_cpu"]:
            raise AssertionError(f"19a {k} counters: card {r['counters']} "
                                 f"!= CPU {r['counters_cpu']}")
    for k, r in clipped.items():
        if r["counters"] != r["counters_cpu"]:
            raise AssertionError(f"19a full-size {k} counters: card "
                                 f"{r['counters']} != CPU "
                                 f"{r['counters_cpu']}")
        if not (r["apart_share"] <= SYNTH_FLIP_SHARE
                and r["unexplained_pixels"] == 0):
            raise AssertionError(f"19a full-size {k}: {r['apart_pixels']} "
                                 f"of {r['pixels']} pixels apart, "
                                 f"{r['unexplained_pixels']} not a "
                                 f"threshold flip")
    if not (clipped["object"]["counters"]["overflow_tiles"] > 0
            and clipped["object"]["counters"]["overflow_gaussians"] > 0):
        raise AssertionError(f"19a full-size object: the capacities did not "
                             f"clip {clipped['object']['counters']}")
    if [c["blend_launches"] for c in clipped.values()] != [
            len(SYNTH_CLIP_VIEWS), mr.CHUNK_VIEWS]:
        raise AssertionError(f"19a full-size blend launches {clipped}")
    want = {"object": 40, "scene": SYNTH_SMALL["frames"]}
    got = {"object": o["blend_launches_per_object"],
           "scene": s["blend_launches_per_scene"]}
    if got != want:
        raise AssertionError(f"19a blend launches {got} != {want}")
    if gen["objects"]["blend_launches"] != 40 * f["objects"] or \
            gen["scenes"]["blend_launches"] != f["frames"] * f["scenes"]:
        raise AssertionError(f"19b generator launches {gen}")
    return out


# ---------------------------------------------------------------------------
# 20. The recipes as configured: LPIPS on
# ---------------------------------------------------------------------------

LPIPS_ON = ("system.use_lpips=true", "system.allow_random_lpips=true")
# the training configs, each run at its own batch_size: every one fits
# the card's 80 GB (`python3 chip_smoke.py --recipe-memory`, PERF.md §5)
RECIPES = ("diffusionGS_rel.yaml", "diffusionGS_rel_512.yaml",
           "diffusionGS_scene.yaml", "diffusionGS_scene_512.yaml")
CHECK_RECIPE = "diffusionGS_rel.yaml"   # the LPIPS checks' batch
LPIPS_PAIRS = 8
LPIPS_RTOL = 2e-4           # the value, card against CPU
LPIPS_GRAD_REL = 1e-3       # d lpips / d render, rel-max, card against CPU
LAMBDA_OVER_REPEAT = 10.0   # the lambda's gradient change over two equal steps'
LPIPS_ITERS = 2
MEMORY_SIZES = (1, 2, 4, 8, 16)   # --recipe-memory: b tried below the config's


def recipe_views(cfg) -> tuple:
    """(input views, rendered views) of a training config's data block:
    gen_views + sel_views (objects), sel_views + 1 of sel_views +
    sel_views_train (scenes)."""
    d = cfg.data
    if "gen_views" in d:
        return int(d["gen_views"]), int(d["gen_views"]) + int(d["sel_views"])
    return (int(d["sel_views"]) + 1,
            int(d["sel_views"]) + int(d["sel_views_train"]))


def lpips_term(torch, params, render, target):
    """compute_losses's LPIPS term on [n, 3, h, w] renders in [0, 1]
    (resize to 256², scale to [-1, 1], VGG on both): the n values and the
    gradient of their sum with respect to `render`."""
    from open_diffusiongs_tpu_torch.systems import losses
    r = render.detach().requires_grad_()

    def scaled(x):
        return (losses.resize_bilinear_256(x) * 2.0 - 1.0).contiguous()

    value = losses.lpips(params, scaled(r), scaled(target))
    (grad,) = torch.autograd.grad(value.sum(), r)
    return value.detach(), grad


def lpips_routed(torch, params, x, y, routes=None):
    """losses.lpips(params, x, y) with x's ReLU masks and max-pool
    indices recorded (`routes` None) or replayed from `routes`: where a
    pool window or a ReLU sits at an exact tie (the flat background of a
    random-init render ties everywhere) both devices then take the same
    subgradient.  Returns (values [n], routes)."""
    from open_diffusiongs_tpu_torch.systems import losses
    F = torch.nn.functional
    record = routes is None
    routes = [] if record else list(routes)
    shift = torch.from_numpy(losses._LPIPS_SHIFT).to(x.device)
    scale = torch.from_numpy(losses._LPIPS_SCALE).to(x.device)
    h = (x - shift.reshape(1, 3, 1, 1)) / scale.reshape(1, 3, 1, 1)
    feats, taken = [], iter(routes)
    for si, (_, n_convs) in enumerate(losses.VGG_STAGES):
        for ci in range(n_convs):
            p = params[f"vgg/{si}_{ci}"]
            pre = F.conv2d(h, p["kernel"], p["bias"], padding=1)
            mask = (pre > 0) if record else next(taken)
            h = pre * mask
            if record:
                routes.append(mask)
        feats.append(h)
        if si < len(losses.VGG_STAGES) - 1:
            if record:
                h, idx = F.max_pool2d(h, 2, 2, return_indices=True)
                routes.append(idx)
            else:
                idx = next(taken)
                h = h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    with torch.no_grad():
        target = losses._vgg_features(params, y)
    return losses.lpips_heads(params, feats, target), routes


def lpips_term_ms(torch, params, render, target) -> float:
    """Device ms of lpips_term (forward and the render's backward)."""
    return cuda_ms(lambda: lpips_term(torch, params, render, target),
                   LPIPS_ITERS)


def step_renders(torch, system, fn) -> tuple:
    """fn()'s result and the renders its train_loss handed
    compute_losses, detached."""
    from open_diffusiongs_tpu_torch.systems import losses
    seen, compute = [], losses.compute_losses

    def recording(rendering, *args, **kw):
        seen.append(rendering.detach())
        return compute(rendering, *args, **kw)

    losses.compute_losses = recording
    try:
        out = fn()
    finally:
        losses.compute_losses = compute
    return out, seen[0]


class LpipsSpans:
    """CUDA events at the edges of every losses.lpips call while open:
    the device span of the loss's `lpips` range (the term's forward
    kernels, on one stream) without a profiler's host cost."""

    def __init__(self, torch):
        self.torch, self.events = torch, []

    def __enter__(self):
        from open_diffusiongs_tpu_torch.systems import losses
        self.losses, self.lpips = losses, losses.lpips

        def timed(*args, **kw):
            edges = [self.torch.cuda.Event(enable_timing=True)
                     for _ in range(2)]
            edges[0].record()
            out = self.lpips(*args, **kw)
            edges[1].record()
            self.events.append(edges)
            return out

        losses.lpips = timed
        return self

    def __exit__(self, *exc) -> None:
        self.losses.lpips = self.lpips

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def lpips_checks(torch, dev, system, batch) -> dict:
    """20 on the object recipe's batch: the DiT's gradients at step 151
    with the config's lambda_lpips (twice) and with 0.0 on the same noise
    and t; LPIPS on the card against the CPU on LPIPS_PAIRS of that
    step's render / target pairs; the term with TF32 on, measured only."""
    import dataclasses

    from open_diffusiongs_tpu_torch.systems import losses
    from open_diffusiongs_tpu_torch.utils.schedules import C
    shape = batch["rgbs_input"].shape
    gen = torch.Generator(device=dev).manual_seed(11)
    noise = torch.randn(shape, generator=gen, device=dev)
    t = torch.randint(0, system.cfg.num_train_timesteps, shape[:1],
                      generator=gen, device=dev)
    params = dict(system.model.named_parameters())
    dit = [n for n in params if n.startswith("transformer.")]
    lam = system.cfg.lambda_lpips

    def dit_grads(lambda_lpips):
        saved = system.cfg
        system.cfg = dataclasses.replace(saved, lambda_lpips=lambda_lpips)
        try:
            system.model.zero_grad(set_to_none=True)
            loss, m = system.train_loss(batch, TRAIN_START_STEP, noise=noise,
                                        t=t)
            loss.backward()
        finally:
            system.cfg = saved
        return float(m["loss_lpips"]), {n: params[n].grad.clone()
                                        for n in dit}

    (lp, on), render = step_renders(torch, system, lambda: dit_grads(lam))
    _, again = dit_grads(lam)
    _, off = dit_grads(0.0)
    system.model.zero_grad(set_to_none=True)

    def max_diff(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in dit)

    grads = {"lambda_lpips_at_step": C(lam, TRAIN_START_STEP),
             "loss_lpips": lp,
             "dit_grad_max_abs": max(float(on[n].abs().max()) for n in dit),
             "dit_grad_max_diff_lambda_0": max_diff(on, off),
             "dit_grad_max_diff_repeat": max_diff(on, again),
             "repeat_bit_identical": all(torch.equal(on[n], again[n])
                                         for n in dit)}
    del on, again, off

    # card against CPU, the same seed-0 VGG
    n, h, w = shape[0] * render.shape[1], render.shape[-2], render.shape[-1]
    x = render.reshape(n, 3, h, w)
    y = batch["rgbs"].float().reshape(n, 3, h, w)
    cpu_params = losses.lpips_init_params(None, device="cpu")
    same_vgg = all(torch.equal(system.lpips_params[k]["kernel"].cpu(),
                               cpu_params[k]["kernel"])
                   for k in cpu_params if k.startswith("vgg/"))
    xs, ys = x[:LPIPS_PAIRS], y[:LPIPS_PAIRS]
    card_v, card_g = lpips_term(torch, system.lpips_params, xs, ys)

    def rel_max(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # value and gradient on the card's ReLU / max-pool decisions, on both
    # devices; the routed value is the plain one (a tie's two sides are
    # equal)
    def routed(params, xi, yi, routes=None):
        r = xi.detach().requires_grad_()

        def scaled(t):
            return (losses.resize_bilinear_256(t) * 2.0 - 1.0).contiguous()

        value, routes = lpips_routed(torch, params, scaled(r), scaled(yi),
                                     routes)
        (g,) = torch.autograd.grad(value.sum(), r)
        return value.detach(), g, routes

    t_cpu = time.perf_counter()
    card_rv, card_rg, routes = routed(system.lpips_params, xs, ys)
    cpu_v, cpu_g, _ = routed(cpu_params, xs.cpu(), ys.cpu(),
                             [r.cpu() for r in routes])
    cpu_s = time.perf_counter() - t_cpu
    del routes
    value_rel = float(((card_v.cpu() - cpu_v).abs() / cpu_v.abs()).max())
    grad_rel = rel_max(card_rg.cpu(), cpu_g)
    routed_vs_plain = max(rel_max(card_rg, card_g),
                          float(((card_rv - card_v).abs()
                                 / card_v.abs()).max()))

    # TF32 in cuDNN's convolutions, measured and restored
    f32_ms = lpips_term_ms(torch, system.lpips_params, x, y)
    f32_v = lpips_term(torch, system.lpips_params, x, y)[0]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_ms = lpips_term_ms(torch, system.lpips_params, x, y)
        tf32_v = lpips_term(torch, system.lpips_params, x, y)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = before
    out = {"gradients_step_151": grads,
           "card_vs_cpu": {"pairs": LPIPS_PAIRS, "same_vgg": same_vgg,
                           "value_max_rel_err": value_rel,
                           "grad_rel_max_err_card_routing": grad_rel,
                           "card_routed_vs_plain": routed_vs_plain,
                           "values": card_v.tolist(),
                           "routed_passes_seconds": cpu_s},
           "tf32": {"images": n, "f32_ms": f32_ms, "tf32_ms": tf32_ms,
                    "value_max_rel_dev": float(
                        ((tf32_v - f32_v).abs() / f32_v.abs()).max()),
                    "mean_rel_dev": abs(float(tf32_v.mean() / f32_v.mean())
                                        - 1.0),
                    "restored": torch.backends.cudnn.allow_tf32 is before}}
    if not same_vgg:
        raise AssertionError("20: the card's VGG is not the CPU's draws")
    if not value_rel <= LPIPS_RTOL:
        raise AssertionError(f"20: LPIPS card vs CPU {value_rel:.3g} > "
                             f"{LPIPS_RTOL}")
    if not max(grad_rel, routed_vs_plain) <= LPIPS_GRAD_REL:
        raise AssertionError(f"20: LPIPS gradient card vs CPU {grad_rel:.3g}"
                             f" (the routed card value / gradient vs the "
                             f"plain ones {routed_vs_plain:.3g}) > "
                             f"{LPIPS_GRAD_REL}")
    if not (math.isfinite(lp) and lp > 0):
        raise AssertionError(f"20: loss_lpips {lp}")
    if not (grads["dit_grad_max_diff_lambda_0"] > 0 and
            grads["dit_grad_max_diff_lambda_0"]
            > LAMBDA_OVER_REPEAT * grads["dit_grad_max_diff_repeat"]):
        raise AssertionError(f"20: lambda_lpips does not reach the DiT: "
                             f"{grads}")
    return out


def recipe_after(torch, dev, checks: bool, system, batch) -> dict:
    """phase_train's `after` in phase 20: the LPIPS term alone on the
    step's shapes (the supervision views, each against its neighbour),
    and on the object recipe lpips_checks."""
    rgbs = batch["rgbs"].float()
    x = rgbs.reshape(-1, *rgbs.shape[2:])
    out = {"lpips_images": x.shape[0],
           "lpips_fwd_bwd_ms": lpips_term_ms(torch, system.lpips_params, x,
                                             x.roll(1, 0))}
    if checks:
        out.update(lpips_checks(torch, dev, system, batch))
    return out


def phase_recipes(torch, dev) -> dict:
    """20: each training config as configured, LPIPS on (module
    docstring)."""
    from open_diffusiongs_tpu_torch.utils.config import load_config
    out = {"allocated_at_start_bytes": torch.cuda.memory_allocated(dev),
           "recipes": {}, "card": card_line()}
    for name in RECIPES:
        config = os.path.join(ROOT, "configs", name)
        cfg = load_config(config, makedirs=False)
        n_in, views = recipe_views(cfg)
        if n_in != N_VIEWS:
            raise AssertionError(f"20 {name}: {n_in} input views")
        t0 = time.perf_counter()
        with LpipsSpans(torch) as spans:
            res = phase_train(
                torch, dev, f"20 {name}", config, overrides=LPIPS_ON,
                sup_views=views,
                after=lambda system, batch, c=(name == CHECK_RECIPE):
                    recipe_after(torch, dev, c, system, batch))
        # the loss's lpips calls: the warm-up step's, then the timed ones
        range_ms = spans.ms()[1:1 + TRAIN_STEPS]
        secs, device_ms = res["seconds_per_step"], res["device_ms_per_step"]
        out["recipes"][name] = {
            "batch_configured": int(cfg.data["batch_size"]),
            "batch_run": res["batch_size"],
            "resolution": int(cfg.data["training_res"][0]),
            "views": f"{n_in} in, {views} rendered",
            "seconds_per_step": secs, "device_ms_per_step": device_ms,
            "device_idle_share": 1.0 - device_ms / 1e3 / secs,
            "lpips_range_device_ms": statistics.median(range_ms),
            "lpips_fwd_bwd_ms": res["after"]["lpips_fwd_bwd_ms"],
            "max_memory_allocated_bytes": res["max_memory_allocated_bytes"],
            "loss_terms": res["loss_terms"], "launches": res["launches"],
            "host_seconds": time.perf_counter() - t0,
            "profile_seconds": res["profile_seconds"],
            "after_seconds": res["after_seconds"]}
        if name == CHECK_RECIPE:
            out["checks"] = {k: res["after"][k] for k in
                             ("gradients_step_151", "card_vs_cpu", "tf32")}
        del res
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"][k]
                              for r in out["recipes"].values())
                       for k in next(iter(out["recipes"].values()))
                       ["launches"]}
    print(f"[20 recipes] {json.dumps(out)}", flush=True)
    for name, r in out["recipes"].items():
        if not r["loss_terms"]["loss_lpips"] > 0:
            raise AssertionError(f"20 {name}: loss_lpips "
                                 f"{r['loss_terms']['loss_lpips']}")
    return out


def live_bytes_by_module(snapshot: dict) -> dict:
    """Live bytes of a torch.cuda.memory snapshot by the innermost frame
    of this package that allocated them ("before recording" where no
    frame was recorded: the params, moments and EMA)."""
    by = {}
    for seg in snapshot["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            where = "before recording"
            for fr in blk.get("frames") or []:
                path = fr.get("filename", "")
                if "open_diffusiongs_tpu_torch" in path:
                    where = path.split("open_diffusiongs_tpu_torch/")[-1]
                    break
                where = "outside the package"
            by[where] = by.get(where, 0) + blk["size"]
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def recipe_memory(torch, dev, name: str) -> dict:
    """The LPIPS-on train step's peak memory for configs/<name> at b = 1,
    2, 4, ... up to the config's batch_size (a step, then one from a
    reset peak), stopping at the first b that does not fit; and at b = 1
    the live memory at the end of the forward by module.  A measurement
    behind RECIPES (`--recipe-memory`), not a phase: it
    catches the out-of-memory error that ends its sweep."""
    from open_diffusiongs_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer, make_train_step)
    from open_diffusiongs_tpu_torch.systems.builder import (
        build_optimizer_config, build_system)
    from open_diffusiongs_tpu_torch.utils.config import load_config
    config = os.path.join(ROOT, "configs", name)
    cfg = load_config(config, cli_args=list(LPIPS_ON), makedirs=False)
    _, views = recipe_views(cfg)
    b_cfg, res = int(cfg.data["batch_size"]), int(cfg.data["training_res"][0])
    system = build_system(cfg.system_type, cfg.system, device=dev)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    params = dict(system.model.named_parameters())
    optimizer = make_optimizer(build_optimizer_config(cfg.system,
                                                      cfg.trainer),
                               params.items())
    state = init_train_state(params, optimizer, ema_decay=0.9999)
    state.step = TRAIN_START_STEP
    gen = torch.Generator(device=dev).manual_seed(7)
    step = make_train_step(
        lambda batch, s: system.train_loss(batch, s, generator=gen),
        optimizer, ema_decay=0.9999)
    out = {"config": name, "batch_configured": b_cfg, "views": views,
           "resolution": res, "state_bytes": torch.cuda.memory_allocated(dev),
           "peak_bytes": {}, "card": card_line()}
    batch = train_batch(torch, dev, 1, res, views)
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    try:
        loss, _ = system.train_loss(batch, TRAIN_START_STEP, generator=gen)
        torch.cuda.synchronize()
        out["forward_end_bytes_b1"] = torch.cuda.memory_allocated(dev)
        out["forward_end_by_module_b1"] = live_bytes_by_module(
            torch.cuda.memory._snapshot())
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del loss
    for b in [s for s in MEMORY_SIZES if s < b_cfg] + [b_cfg]:
        batch = train_batch(torch, dev, b, res, views)
        try:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            out["peak_bytes"][b] = torch.cuda.max_memory_allocated(dev)
            out.setdefault("seconds_per_step", {})[b] = \
                time.perf_counter() - t0
        except torch.OutOfMemoryError as e:
            out["out_of_memory_at"] = b
            out["out_of_memory"] = str(e).splitlines()[0]
            break
        finally:
            del batch
            optimizer.zero_grad()
            torch.cuda.empty_cache()
    print(f"[recipe memory] {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import logging
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import open_diffusiongs_tpu_torch as port
    dev = port.require_cuda()
    if sys.argv[1:] == ["--recipe-memory"]:
        # whether phase 20 can run each recipe at its own b; no phases
        phase_device(torch)
        phase_build()
        for name in RECIPES:
            recipe_memory(torch, dev, name)
            torch.cuda.empty_cache()
        print(card_line())
        return 0

    seconds = {}        # host seconds of each phase, printed at the end

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("1 device", phase_device, torch)
    timed("2 build", phase_build)
    attn = timed("3 attention", phase_attention, torch, dev)
    system = timed("system", build_system, torch, dev)
    blend, views = timed("4 blend", phase_blend, torch, dev, system)
    kept_256 = []       # phase 5's timed asset, for phase 15
    main_res = timed("5 main path", phase_main, torch, dev, system, kept_256)
    attn_train = timed("6 attention training", phase_attention_train,
                       torch, dev)
    blend_bwd = timed("7 blend backward", phase_blend_bwd, torch, dev, views)
    del views
    # phase 15b samples with this system again: parked on the host until
    # then, off the peaks of phases 8-14
    system.model.to("cpu")
    torch.cuda.empty_cache()
    train = timed("8 train path", phase_train, torch, dev)
    torch.cuda.empty_cache()
    general = timed("9a general kernel", phase_general_kernel, torch, dev)
    smax = timed("9b scalar max", phase_smax, torch, dev)
    general_sampling = timed("9c general sampling", phase_general_sampling,
                             torch, dev)
    torch.cuda.empty_cache()
    timed("9d qk_norm stack", phase_qk_norm_stack, torch, dev)
    torch.cuda.empty_cache()
    bench = timed("9e bench variants", phase_bench_variants, torch, dev)
    timed("9f dh 16", phase_dh16, torch, dev)
    timed("9g odd shapes", phase_odd_shapes, torch, dev)
    torch.cuda.empty_cache()
    # 10-12 share one temporary directory (the reference checkpoint and
    # the pretrained directory made from it), deleted on the way out
    with tempfile.TemporaryDirectory() as tmp:
        load, pipe, pretrained, spot = timed("10 load", phase_load, torch,
                                             dev, tmp)
        kept_512 = []   # phase 11's trained-statistics asset, for 15a-b
        sample_512 = timed("11 512^2 sampling", phase_sample_512, torch, dev,
                           pipe, pretrained, kept_512)
        del pipe
        torch.cuda.empty_cache()
        train_512 = timed("12 512^2 train step", phase_train_512, torch, dev,
                          pretrained, spot)
    torch.cuda.empty_cache()
    # 13-14 write their trees, trial dirs and checkpoints in temporary
    # directories, deleted on the way out
    with tempfile.TemporaryDirectory() as tmp:
        launch_train = timed("13 launch train", phase_launch_train, torch,
                             dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        scene_eval = timed("14 scene eval", phase_scene_eval, torch, dev, tmp)
    torch.cuda.empty_cache()
    serving = timed("15 serving surface", phase_serving, torch, dev, system,
                    kept_256[0].gaussians, kept_256[0].renders,
                    kept_512[0].gaussians)
    del system, kept_256, kept_512
    torch.cuda.empty_cache()
    general_kernels = timed("16a general-route training kernels",
                            phase_general_train_kernels, torch, dev)
    torch.cuda.empty_cache()
    qk_train = timed("16b qk_norm stack training", phase_qk_norm_train,
                     torch, dev)
    torch.cuda.empty_cache()
    general_train = timed("16c general-route train step",
                          phase_general_train, torch, dev)
    torch.cuda.empty_cache()
    split = timed("17a split extents", phase_split_extents, torch, dev)
    torch.cuda.empty_cache()
    # 17b's tree, rendezvous, trial dir and checkpoint: deleted on the way
    # out
    with tempfile.TemporaryDirectory() as tmp:
        parallel = timed("17b parallel", phase_parallel, torch, dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        par18 = timed("18 tensor / pipeline parallel, serving",
                      phase_parallel18, torch, dev, tmp)
    torch.cuda.empty_cache()
    # 19's trees and trial dirs: deleted on the way out
    with tempfile.TemporaryDirectory() as tmp:
        synth = timed("19 synthetic trees", phase_synthetic, torch, dev, tmp)
    torch.cuda.empty_cache()
    recipes = timed("20 recipes as configured", phase_recipes, torch, dev)
    ring = {k: parallel["sp2"][k] for k in ("step_launches",
                                            "sampler_launches")}
    print(f"[phase seconds] {json.dumps(seconds)}", flush=True)
    print("[host split] " + json.dumps({
        f"{RES}^2": main_res["host_split"],
        f"{RES_512}^2": sample_512["init"]["host_split"],
        "card": card_line()}), flush=True)

    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "flax", "optax", "orbax", "lpips")
                    or m.startswith(("jax.", "open_diffusiongs_tpu."))
                    or m == "open_diffusiongs_tpu")
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")

    def cli_launches(counter):
        """A main-path row's launches in phases 13 (the train, resume and
        export calls) and 14."""
        return {"launches_launch_train":
                    launch_train["launches_total"][counter],
                "launches_scene_eval": scene_eval["launches"][counter]}

    def par18_launches(counter, serving_key=None):
        """A row's launches per rank in phase 18: a tp = 2 and a pp = 2
        step, and a dp = 2 served bundle."""
        out = {f"launches_{k}_per_rank_per_step":
               par18[k]["step_launches"].get(counter, 0)
               for k in ("tp2", "pp2")}
        if serving_key is not None:
            out["launches_dp2_serving_per_rank"] = \
                par18["dp2_serving"][0]["launches_per_rank"][serving_key]
        return out

    def synth_launches(counter):
        """A row's launches in phase 19: the generators' renders (19a on
        the card, 19b) and the two 20-step `launch --train` runs."""
        return {"launches_synthetic": synth["launches"][counter]}

    def recipe_launches(counter):
        """A training row's launches in phase 20: the four recipes' 3
        timed steps each."""
        return {"launches_recipes": recipes["launches"][counter]}

    src = "open_diffusiongs_tpu_torch/csrc/"
    density = serving["density"][1]     # phase 5's asset at 256
    t64, t48 = (general_kernels["times"][k] for k in ("h16_d64", "h16_d48"))
    kernels = [
        {"name": "flash_mha_packed", "route": "cuda",
         "source": src + "flash_attn_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/attention.py:221",
         "launches": main_res["launches"]["attention"],
         "max_abs_err": attn["max_abs_err"], "ms": attn["ms"],
         "plain_ms": attn["plain_ms"], **roof(attn),
         "library_ms": attn["sdpa_ms"],
         **{k: v for k, v in attn.items() if k.endswith("_L16386")},
         "launches_512": sample_512["init"]["launches"]["attention"],
         **cli_launches("attention.LAUNCHES"),
         "launches_dp2_serving_per_rank":
             par18["dp2_serving"][0]["launches_per_rank"]["attention"],
         **synth_launches("attention.LAUNCHES")},
        {"name": "blend_tiles", "route": "cuda",
         "source": src + "blend_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/blend_kernel.py:63",
         "launches": main_res["launches"]["blend"],
         "max_abs_err": max(r["max_abs_err"] for r in blend),
         "ms": blend[0]["ms"], "plain_ms": blend[0]["plain_ms"],
         **roof(blend[0]), "library_ms": None, **trained_times(blend),
         "launches_512": sample_512["init"]["launches"]["blend"],
         **cli_launches("blend_kernel.LAUNCHES"),
         **par18_launches("blend_kernel.LAUNCHES", "blend"),
         **synth_launches("blend_kernel.LAUNCHES"),
         **recipe_launches("blend_fwd")},
        {"name": "flash_mha_packed(with_stats=True)", "route": "cuda",
         "source": src + "flash_attn_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/attention.py:212",
         "launches": train["launches"]["attention_fwd_lse"],
         "max_abs_err": attn_train["max_abs_err_fwd"],
         "ms": attn_train["fwd_stats_ms"],
         "plain_ms": attn_train["fwd_stats_plain_ms"],
         **roof(attn_train["fwd_stats_bound"]),
         "library_ms": attn_train["sdpa_fwd_ms"],
         "launches_512": train_512["launches"]["attention_fwd_lse"],
         **cli_launches("attention.LAUNCHES_STATS"),
         # phase 17: one rank's launches of a 512^2 sp = 2 step and of a
         # no-grad DiT pass through the ring; the split-extent check
         "launches_ring_per_rank_per_step":
             ring["step_launches"]["LAUNCHES_STATS"],
         "launches_ring_dit_pass": ring["sampler_launches"]["LAUNCHES_STATS"],
         "split_extent_max_abs_err": split["max_abs_err_fwd"],
         "ms_ring_step_L16896_sp2":
             split["ring_step_L16896_sp2"]["fwd_stats_ms"],
         **par18_launches("attention.LAUNCHES_STATS"),
         **synth_launches("attention.LAUNCHES_STATS"),
         **recipe_launches("attention_fwd_lse")},
        {"name": "flash_mha_packed_bwd", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/attention.py:435",
         "launches": train["launches"]["attention_bwd"],
         "max_abs_err": attn_train["max_abs_err_bwd"],
         "ms": attn_train["bwd_ms"], "plain_ms": attn_train["bwd_plain_ms"],
         **roof(attn_train["bwd_bound"]),
         "library_ms": attn_train["sdpa_bwd_ms"],
         "launches_512": train_512["launches"]["attention_bwd"],
         **cli_launches("attention.LAUNCHES_BWD"),
         "launches_ring_per_rank_per_step":
             ring["step_launches"]["LAUNCHES_BWD"],
         "split_extent_max_abs_err": split["max_abs_err_bwd"],
         "ms_ring_step_L16896_sp2": split["ring_step_L16896_sp2"]["bwd_ms"],
         **par18_launches("attention.LAUNCHES_BWD"),
         **synth_launches("attention.LAUNCHES_BWD"),
         **recipe_launches("attention_bwd")},
        {"name": "blend_bwd", "route": "cuda",
         "source": src + "blend_bwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/blend_kernel.py:117",
         "launches": train["launches"]["blend_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in blend_bwd),
         "ms": blend_bwd[0]["ms"], "plain_ms": blend_bwd[0]["plain_ms"],
         **roof(blend_bwd[0]), **trained_times(blend_bwd),
         "library_ms": None,
         "launches_512": train_512["launches"]["blend_bwd"],
         **cli_launches("blend_kernel.LAUNCHES_BWD"),
         **par18_launches("blend_kernel.LAUNCHES_BWD"),
         **synth_launches("blend_kernel.LAUNCHES_BWD"),
         **recipe_launches("blend_bwd")},
        {"name": "flash_full_mha", "route": "cuda",
         "source": src + "flash_full_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/attention.py:44",
         "launches": general_sampling["launches"]["LAUNCHES_FULL"],
         "max_abs_err": general["max_abs_err"], "ms": general["ms"],
         "plain_ms": general["plain_ms"], **roof(general),
         "library_ms": general["sdpa_ms"]},
        {"name": "flash_mha_packed(scalar_max=True)", "route": "cuda",
         "source": src + "flash_attn_fwd.cu",
         "replaces": "open_diffusiongs_tpu/ops/attention.py:146",
         "launches": bench["launches"]["LAUNCHES_SMAX"],
         "max_abs_err": smax["max_abs_err"], "ms": smax["ms"],
         "plain_ms": smax["plain_ms"], **roof(smax),
         "library_ms": smax["sdpa_ms"]},
        {"name": "mha_full", "route": "cuda",
         "source": src + "flash_full_fwd.cu",
         "replaces": "tools/bench_attn2.py:43",
         "launches": bench["launches"]["LAUNCHES_MHA_FULL"],
         "max_abs_err": max(r["max_abs_err"] for n, r in
                            bench["check"].items() if n.startswith("mha")),
         "ms": bench["sweep"]["mha_full"]["ms"],
         "plain_ms": bench["plain_ms"], **roof(bench),
         "library_ms": bench["sdpa_ms"]},
        {"name": "density_grid", "route": "cuda",
         "source": src + "density_grid.cu",
         "replaces": "open_diffusiongs_tpu/ops/mesh.py:312 (eval_block, "
                     "an XLA fusion; no Pallas counterpart)",
         "launches": serving["mesh"]["asset"]["launches"],
         "max_abs_err": max(c["max_abs_err"] for c in serving["density"]),
         "ms": density["ms"], "plain_ms": density["plain_ms"],
         **roof(density), "library_ms": None,
         # the twin runs on every 8th slab: its pairs, and the kernel's
         # time on the same slabs, beside the whole grid's; the bound
         # counts the live pairs, the all-pairs bound every pair
         "pairs": density["pairs"], "plain_pairs": density["twin_pairs"],
         "ms_on_plain_slabs": density["ms_on_twin_slabs"],
         **{f"{k}{suffix}": c[k]
            for c, suffix in zip(serving["density"],
                                 ("_shell_128", "", "_trained_512"))
            for k in ("ms", "ms_no_cull", "live_pairs", "tile_tests",
                      "bound_ms", "bound_all_pairs_ms")
            if suffix or k not in ("ms", "bound_ms")},
         "launches_cli": serving["u2net_cli"]["cli_density_launches"]},
        # the general route's training pair, at b = 4, L = 4098, 16 heads
        # of 64 (and of 48 beside); launches in phase 16c's three steps
        {"name": "flash_full_mha_stats", "route": "cuda",
         "source": src + "flash_full_fwd.cu",
         "replaces": "open_diffusiongs_tpu/models/transformer.py:141 "
                     "(_ffsb_fwd: splash's forward, a JAX library kernel; "
                     "the STATS flag of #5's file)",
         "launches": general_train["launches"]["general_fwd_lse"],
         "max_abs_err": general_kernels["max_abs_err_fwd"],
         "ms": t64["fwd_ms"], "plain_ms": t64["fwd_plain_ms"],
         **roof(t64["fwd_bound"]), "library_ms": t64["sdpa_fwd_ms"],
         "ms_d48": t48["fwd_ms"], "bound_ms_d48": t48["fwd_bound"]["bound_ms"],
         "library_ms_d48": t48["sdpa_fwd_ms"],
         "launches_qk_norm_stack": qk_train["launches"]["LAUNCHES_FULL_STATS"]},
        {"name": "flash_full_mha_bwd", "route": "cuda",
         "source": src + "flash_full_bwd.cu",
         "replaces": "open_diffusiongs_tpu/models/transformer.py:148 "
                     "(_ffsb_bwd: splash's backward, a JAX library kernel)",
         "launches": general_train["launches"]["general_bwd"],
         "max_abs_err": general_kernels["max_abs_err_bwd"],
         "ms": t64["bwd_ms"], "plain_ms": t64["bwd_plain_ms"],
         **roof(t64["bwd_bound"]), "library_ms": t64["sdpa_bwd_ms"],
         "ms_d48": t48["bwd_ms"], "bound_ms_d48": t48["bwd_bound"]["bound_ms"],
         "library_ms_d48": t48["sdpa_bwd_ms"],
         "launches_qk_norm_stack": qk_train["launches"]["LAUNCHES_FULL_BWD"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
