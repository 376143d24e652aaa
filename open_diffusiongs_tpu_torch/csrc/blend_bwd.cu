// Per-tile alpha blend of the Gaussian rasterizer, backward.
//
// Replaces the TPU Pallas kernel open_diffusiongs_tpu/ops/blend_kernel.py::
// blend_bwd_pallas (body _blend_bwd_kernel, :117-218): per-candidate
// gradient rows dg [T, K, 10] of the blend of blend_fwd.cu, for cotangents
// of its three outputs (t_fin, acc_c, acc_d).  Same algebra as the TPU
// kernel: the candidates are re-walked in FORWARD order, recomputing the
// forward state exactly (transmittance T_i, skip, early stop), with one
// per-pixel running sum in place of the back-to-front suffix sums of the
// reference backward (backward.cu:399-557):
//   A_i = dC . rgb_i + dD z_i,   Q_i = sum_{j<=i} w_j A_j,
//   e   = dC . acc_c + dD acc_d + dT t_fin   (from the forward outputs),
//   dL/dalpha_i = T_i A_i - (e - Q_i) / (1 - alpha_i)   for contributors,
// and through alpha_i = min(0.99, o_i exp(power_i)) only while
// o_i exp(power_i) < 0.99 (the clamp's gradient gate).  Skipped, stopping
// and post-stop candidates get zero rows, as do slots >= counts[t].
//
// Design: the shape of blend_fwd.cu — one 256-thread block per 16x16 tile,
// one thread per pixel, candidates read through the [T, K] index list from
// the packed [N + 1, 10] table, 32 per round through shared memory.  Each
// candidate's 10 gradient entries are summed over the tile's 256 pixels in
// the block: a warp-shuffle butterfly per warp (skipped when no pixel of
// the warp contributes), then a fixed-order sum of the 8 warp partials —
// no atomics, so dg is bit-for-bit deterministic; every row is written
// once.  The block leaves the candidate loop once every pixel has stopped.
// IEEE expf (no fast-math), like the forward: T_i is rebuilt bit-exactly.
//
// What bounds it: per view at 256^2 the reads are the forward's (at most
// 10.5 MB of candidate rows) plus 10 f32 writes per candidate; the work per
// live (pixel, candidate) is one expf and ~40 FMAs, and per candidate and
// warp one vote plus 50 shuffles when the warp contributes.  The shuffle
// reductions dominate once footprints are small; later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int PPT = TILE * TILE;   // pixels per tile = threads per block
constexpr int NWARPS = PPT / 32;
constexpr int CH = 32;             // candidates per round
constexpr int NA = 10;             // attribute columns
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;              // forward.cu:344
constexpr float ALPHA_MIN = 1.0f / 255.0f;      // forward.cu:345
constexpr float EARLY_STOP_T = 1e-4f;           // forward.cu:348

__global__ void __launch_bounds__(PPT)
blend_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ idx,
                 const int* __restrict__ counts, int k, int tiles_x,
                 const float* __restrict__ t_fin,
                 const float* __restrict__ acc_c,
                 const float* __restrict__ acc_d,
                 const float* __restrict__ d_tfin,
                 const float* __restrict__ d_accc,
                 const float* __restrict__ d_accd, float* __restrict__ dg) {
  __shared__ float attr[CH * NA];
  __shared__ float part[NWARPS][CH * NA];
  const int t = blockIdx.x, p = threadIdx.x, warp = p >> 5, lane = p & 31;
  const float px = static_cast<float>((t % tiles_x) * TILE + (p % TILE));
  const float py = static_cast<float>((t / tiles_x) * TILE + (p / TILE));
  const int count = counts[t];
  const int* tidx = idx + static_cast<long long>(t) * k;
  float* out = dg + static_cast<long long>(t) * k * NA;

  const long long o = static_cast<long long>(t) * PPT + p;
  const float dc0 = d_accc[3 * o], dc1 = d_accc[3 * o + 1],
              dc2 = d_accc[3 * o + 2], dd = d_accd[o];
  const float e = (dc0 * acc_c[3 * o] + dc1 * acc_c[3 * o + 1] +
                   dc2 * acc_c[3 * o + 2]) +
                  dd * acc_d[o] + d_tfin[o] * t_fin[o];

  float tr = 1.f, q = 0.f;
  bool done = false;
  int end = 0;   // rows [0, end) of this tile are written
  for (int base = 0; base < count; base += CH) {
    // Barrier before the stage overwrites the previous round's attributes
    // and partials, and the block-wide exit once every pixel has stopped.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(CH, count - base);
    for (int c = p; c < n * NA; c += PPT)
      attr[c] = packed[static_cast<long long>(tidx[base + c / NA]) * NA + c % NA];
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* a = attr + i * NA;
      float gr[NA];
#pragma unroll
      for (int c = 0; c < NA; ++c) gr[c] = 0.f;
      bool live = false;
      if (!done) {
        const float dx = a[0] - px, dy = a[1] - py;
        const float power =
            -0.5f * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy;
        if (!(power > 0.f)) {
          const float gexp = expf(power);
          const float og = a[8] * gexp;
          const float alpha = fminf(ALPHA_MAX, og);
          if (!(alpha < ALPHA_MIN)) {
            const float test_t = tr * (1.f - alpha);
            if (test_t < EARLY_STOP_T) {
              done = true;   // the stopping candidate does not contribute
            } else {
              live = true;
              const float w = alpha * tr;
              const float big_a = a[5] * dc0 + a[6] * dc1 + a[7] * dc2 + a[9] * dd;
              q += w * big_a;
              const float dalpha = tr * big_a - (e - q) / (1.f - alpha);
              const bool unclamped = og < ALPHA_MAX;
              const float dpow = unclamped ? dalpha * alpha : 0.f;
              gr[0] = dpow * (-(a[2] * dx + a[3] * dy));   // mean x
              gr[1] = dpow * (-(a[4] * dy + a[3] * dx));   // mean y
              gr[2] = dpow * (-0.5f * dx * dx);            // conic a
              gr[3] = dpow * (-dx * dy);                   // conic b
              gr[4] = dpow * (-0.5f * dy * dy);            // conic c
              gr[5] = w * dc0;
              gr[6] = w * dc1;
              gr[7] = w * dc2;
              gr[8] = unclamped ? dalpha * gexp : 0.f;     // opacity
              gr[9] = w * dd;                              // depth
              tr = test_t;
            }
          }
        }
      }
      if (__any_sync(FULL, live)) {
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          float v = gr[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(FULL, v, off);
          gr[c] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NA; ++c) part[warp][i * NA + c] = gr[c];
      }
    }
    __syncthreads();
    for (int c = p; c < n * NA; c += PPT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += part[w][c];
      out[static_cast<long long>(base) * NA + c] = s;
    }
    end = base + n;
  }
  for (long long c = static_cast<long long>(end) * NA + p;
       c < static_cast<long long>(k) * NA; c += PPT)
    out[c] = 0.f;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// packed [N+1, 10] f32, idx [num_tiles, k] i32, counts [num_tiles] i32
// (counts[t] <= k); forward outputs and their cotangents t_fin / d_tfin
// [num_tiles, 256], acc_c / d_accc [num_tiles, 256, 3], acc_d / d_accd
// [num_tiles, 256]; output dg [num_tiles, k, 10]; all contiguous f32.
extern "C" int odgs_blend_bwd(const void* packed, const void* idx,
                              const void* counts, int num_tiles, int k,
                              int tiles_x, const void* t_fin,
                              const void* acc_c, const void* acc_d,
                              const void* d_tfin, const void* d_accc,
                              const void* d_accd, void* dg, void* stream) {
  if (num_tiles == 0) return 0;
  blend_bwd_kernel<<<num_tiles, PPT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const int*>(counts), k, tiles_x,
      static_cast<const float*>(t_fin), static_cast<const float*>(acc_c),
      static_cast<const float*>(acc_d), static_cast<const float*>(d_tfin),
      static_cast<const float*>(d_accc), static_cast<const float*>(d_accd),
      static_cast<float*>(dg));
  return static_cast<int>(cudaGetLastError());
}
