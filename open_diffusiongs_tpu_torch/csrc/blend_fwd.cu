// Per-tile front-to-back alpha blend of the Gaussian rasterizer (forward).
//
// Replaces the TPU Pallas kernel open_diffusiongs_tpu/ops/blend_kernel.py::
// blend_tiles_pallas (body _blend_kernel, :63-114), with the semantics of
// the reference renderCUDA (forward.cu:261-374):
//   pixel centres at integer coordinates; per candidate
//   power = -1/2 (a dx² + c dy²) - b dx dy,  alpha = min(0.99, o e^power);
//   skip when power > 0 or alpha < 1/255; a pixel stops at the first
//   candidate with T (1 - alpha) < 1e-4, which does not contribute.
// Outputs are the pre-background accumulators: final transmittance
// t_fin [T, 256], colour acc_c [T, 256, 3] and depth acc_d [T, 256], and
// per pixel the slot where its walk ended, n_end [T, 256] int32 (its
// stopping candidate, or counts[t]; the reference's n_contrib), which
// bounds the backward's re-walk.
//
// Input: the [T, K] per-tile candidate index list (depth-sorted, sentinel N
// past counts[t]) plus the packed [N + 1, 10] attribute table whose row N
// is all zeros (x, y, conic a/b/c, r, g, b, opacity, depth).
//
// What bounds it on an H100: not the issue rate.  At init statistics a
// 256² view walks ~8.85 M (pixel, candidate) pairs of ~25 instructions,
// ~7 µs of issue over 132 SMs; the rest is latency (one scattered 40-byte
// row per candidate), imbalance (a tile runs as long as its slowest pixel)
// and work on candidates whose footprint misses the pixels.  Tensor cores
// play no part: the work is a serial per-pixel f32 product with an expf,
// held to f32 bars.
//
// Design (blend.cuh holds the shared pieces):
//   * warps walk independently: each warp owns an 8x4 pixel rectangle of
//     the tile, walks the tile's list on its own and leaves once its 32
//     pixels have stopped; no block barrier.  A block holds half a tile
//     (4 warps: 512 blocks at 256², 2048 at 512²); on the H100 it ran as
//     fast as a whole-tile block at init statistics and a few per cent
//     faster at trained statistics;
//   * a 3-stage cp.async ring per warp: while the warp blends chunk j (32
//     candidates), the rows of j+1 and j+2 are in flight and the indices
//     of j+3 are loaded; each warp stages its own copy of the rows (the
//     other warps' copies of the same rows hit L1), so a stage is released
//     as soon as its one reader has passed it and no warp waits for
//     another;
//   * a conservative cull of whole candidates: at staging, lane l tests
//     candidate l's opacity-aware ellipse box against the warp's rectangle
//     (misses_rect); one ballot gives the chunk's candidates that can touch
//     the rectangle, and the walk visits only those;
//   * the reference's per-pixel arithmetic (blend.cuh::blend_pair: IEEE
//     expf, fminf), the test_t stop and T multiplied sequentially in
//     candidate order: the backward re-walks it bit for bit.  Within a
//     batch of 16 candidates the alphas are formed first, branch-free, so
//     their loads and expfs overlap.

#include "blend.cuh"

namespace {

using namespace odgs_blend;

constexpr int STAGES = 3;
constexpr int BATCH = 16;   // candidates whose alphas are formed together
constexpr int WPB = 4;      // warps per block: half a tile
constexpr int BLOCKS_PER_TILE = TILE_WARPS / WPB;

__global__ void __launch_bounds__(WPB * 32)
blend_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ idx,
                 const int* __restrict__ counts, int k, int tiles_x,
                 float* __restrict__ t_fin, float* __restrict__ acc_c,
                 float* __restrict__ acc_d, int* __restrict__ n_end) {
  __shared__ __align__(16) float ring[WPB][STAGES][CH * NA];
  __shared__ int lists[WPB][CH];   // a chunk's candidates the warp walks
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int t = blockIdx.x / BLOCKS_PER_TILE;
  const int w = (blockIdx.x % BLOCKS_PER_TILE) * WPB + wb;   // warp of tile
  const int tx = (t % tiles_x) * TILE, ty = (t / tiles_x) * TILE;
  const int p = rect_pixel(w, lane);
  const float px = static_cast<float>(tx + p % TILE);
  const float py = static_cast<float>(ty + p / TILE);
  const float rx0 = static_cast<float>(tx + (w % 2) * RECT_W);
  const float ry0 = static_cast<float>(ty + (w / 2) * RECT_H);
  const float rx1 = rx0 + (RECT_W - 1), ry1 = ry0 + (RECT_H - 1);
  const int count = counts[t];
  const int* tidx = idx + static_cast<long long>(t) * k;
  const int nch = (count + CH - 1) / CH;
  float* mine = &ring[wb][0][0];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    stage_rows(mine + s * CH * NA, packed,
               slot_row(tidx, s * CH, count, lane), s * CH, count, lane);
  int next = slot_row(tidx, (STAGES - 1) * CH, count, lane);

  float tr = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  int end = count;
  bool done = false;
  for (int j = 0; j < nch; ++j) {
    const int ahead = j + STAGES - 1;   // its stage held chunk j - 1
    stage_rows(mine + (ahead % STAGES) * CH * NA, packed, next, ahead * CH,
               count, lane);
    next = slot_row(tidx, (ahead + 1) * CH, count, lane);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const float* st = mine + (j % STAGES) * CH * NA;
    const int base = j * CH;
    const int n = compact(
        __ballot_sync(FULL,
                      base + lane < count &&
                          !misses_rect(st + lane * NA, rx0, ry0, rx1, ry1)),
        lists[wb], lane);
    for (int b0 = 0; b0 < n; b0 += BATCH) {
      // the next BATCH candidates, branch-free: their alphas do not depend
      // on T, so their loads and expfs overlap; then T is carried through
      // them in order (a batch slot past the list reads the chunk's first
      // row and is selected away)
      int ci[BATCH];
      float al[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        ci[b] = b0 + b < n ? lists[wb][b0 + b] : -1;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const float alpha = blend_pair(st + max(ci[b], 0) * NA, px, py).alpha;
        al[b] = ci[b] >= 0 ? alpha : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const float alpha = al[b];
        const bool valid = !done && alpha != 0.f;
        const float test_t = tr * (1.f - alpha);
        const bool stop = valid && test_t < EARLY_STOP_T;
        const bool blend = valid && !stop;
        end = stop ? base + ci[b] : end;
        done = done || stop;
        const float2* row =
            reinterpret_cast<const float2*>(st + max(ci[b], 0) * NA);
        const float2 cr = row[2], gb = row[3], oz = row[4];
        const float w8 = alpha * tr;
        c0 = blend ? c0 + cr.y * w8 : c0;
        c1 = blend ? c1 + gb.x * w8 : c1;
        c2 = blend ? c2 + gb.y * w8 : c2;
        dep = blend ? dep + oz.y * w8 : dep;
        tr = blend ? test_t : tr;
      }
      if (__all_sync(FULL, done)) break;
    }
    if (__all_sync(FULL, done)) break;
    __syncwarp();   // every lane has read chunk j (and the list) before
                    // they refill
  }
  cp_async_wait_all();
  const long long o = static_cast<long long>(t) * PPT + p;
  t_fin[o] = tr;
  acc_c[3 * o + 0] = c0;
  acc_c[3 * o + 1] = c1;
  acc_c[3 * o + 2] = c2;
  acc_d[o] = dep;
  n_end[o] = end;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// packed [N+1, 10] f32, idx [num_tiles, k] i32, counts [num_tiles] i32
// (counts[t] <= k); outputs t_fin [num_tiles, 256], acc_c [num_tiles, 256,
// 3], acc_d [num_tiles, 256] f32 and n_end [num_tiles, 256] i32,
// contiguous.
extern "C" int odgs_blend_fwd(const void* packed, const void* idx,
                              const void* counts, int num_tiles, int k,
                              int tiles_x, void* t_fin, void* acc_c,
                              void* acc_d, void* n_end, void* stream) {
  if (num_tiles == 0) return 0;
  blend_fwd_kernel<<<num_tiles * BLOCKS_PER_TILE, WPB * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const int*>(counts), k, tiles_x,
      static_cast<float*>(t_fin), static_cast<float*>(acc_c),
      static_cast<float*>(acc_d), static_cast<int*>(n_end));
  return static_cast<int>(cudaGetLastError());
}
