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
// t_fin [T, 256], colour acc_c [T, 256, 3] and depth acc_d [T, 256].
//
// Input: the [T, K] per-tile candidate index list (depth-sorted, sentinel N
// past counts[t]) plus the packed [N + 1, 10] attribute table whose row N
// is all zeros (x, y, conic a/b/c, r, g, b, opacity, depth).  The TPU
// kernel takes a materialized [T, Kp, 10] row copy; reading through the
// index list skips that copy.
//
// Design: the shape of the reference renderCUDA — one 256-thread block per
// 16x16 tile, one thread per pixel.  Candidates are staged through shared
// memory 256 at a time (one row per thread), then every pixel walks the
// chunk strictly front to back with its own transmittance and its own early
// exit; the block leaves the candidate loop once every pixel has exited
// (__syncthreads_count), the per-pixel stand-in for the TPU kernel's
// chunk-level exit.  T is multiplied sequentially, like CUDA; the JAX scan
// forms it by prefix products, so the two differ by f32 reassociation only.
//
// What bounds it: per view at 256^2 it reads at most 256 tiles x 1024
// candidates x 40 B ≈ 10.5 MB of attribute rows (random rows of the table)
// and evaluates one expf per (pixel, live candidate): ~67 M exp at K = 1024,
// well under a millisecond of SFU/FMA work on 132 SMs.  With only 256 blocks
// per view the card is under-occupied (2 blocks per SM); the scattered row
// loads at each chunk start are exposed latency.  Both are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int PPT = TILE * TILE;   // pixels per tile = threads per block
constexpr int CHUNK = PPT;         // candidates staged per round
constexpr int NA = 10;             // attribute columns
constexpr float ALPHA_MAX = 0.99f;              // forward.cu:344
constexpr float ALPHA_MIN = 1.0f / 255.0f;      // forward.cu:345
constexpr float EARLY_STOP_T = 1e-4f;           // forward.cu:348

__global__ void __launch_bounds__(PPT)
blend_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ idx,
                 const int* __restrict__ counts, int k, int tiles_x,
                 float* __restrict__ t_fin, float* __restrict__ acc_c,
                 float* __restrict__ acc_d) {
  __shared__ float attr[CHUNK * NA];
  const int t = blockIdx.x, p = threadIdx.x;
  const float px = static_cast<float>((t % tiles_x) * TILE + (p % TILE));
  const float py = static_cast<float>((t / tiles_x) * TILE + (p / TILE));
  const int count = counts[t];
  const int* tidx = idx + static_cast<long long>(t) * k;

  float tr = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  bool done = false;
  for (int base = 0; base < count; base += CHUNK) {
    // Barrier before the stage overwrites the previous chunk, and the
    // block-wide exit once every pixel of the tile has stopped.
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + p;
    if (j < count) {
      const float* row = packed + static_cast<long long>(tidx[j]) * NA;
#pragma unroll
      for (int a = 0; a < NA; ++a) attr[p * NA + a] = row[a];
    }
    __syncthreads();
    const int n = min(CHUNK, count - base);
    for (int i = 0; i < n && !done; ++i) {
      const float* a = attr + i * NA;
      const float dx = a[0] - px, dy = a[1] - py;
      const float power =
          -0.5f * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy;
      if (power > 0.f) continue;
      const float alpha = fminf(ALPHA_MAX, a[8] * expf(power));
      if (alpha < ALPHA_MIN) continue;
      const float test_t = tr * (1.f - alpha);
      if (test_t < EARLY_STOP_T) {
        done = true;
        break;
      }
      const float w = alpha * tr;
      c0 += a[5] * w;
      c1 += a[6] * w;
      c2 += a[7] * w;
      dep += a[9] * w;
      tr = test_t;
    }
  }
  const long long o = static_cast<long long>(t) * PPT + p;
  t_fin[o] = tr;
  acc_c[3 * o + 0] = c0;
  acc_c[3 * o + 1] = c1;
  acc_c[3 * o + 2] = c2;
  acc_d[o] = dep;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// packed [N+1, 10] f32, idx [num_tiles, k] i32, counts [num_tiles] i32
// (counts[t] <= k); outputs t_fin [num_tiles, 256], acc_c
// [num_tiles, 256, 3], acc_d [num_tiles, 256], all contiguous f32.
extern "C" int odgs_blend_fwd(const void* packed, const void* idx,
                              const void* counts, int num_tiles, int k,
                              int tiles_x, void* t_fin, void* acc_c,
                              void* acc_d, void* stream) {
  if (num_tiles == 0) return 0;
  blend_fwd_kernel<<<num_tiles, PPT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const int*>(counts), k, tiles_x, static_cast<float*>(t_fin),
      static_cast<float*>(acc_c), static_cast<float*>(acc_d));
  return static_cast<int>(cudaGetLastError());
}
