// Gaussian density field of the mesh export, evaluated for every grid point.
//
// Replaces the per-slab XLA fusion `eval_block` of the JAX package's
// open_diffusiongs_tpu/ops/mesh.py::gaussian_density_grid (:312-322; not a
// Pallas kernel: the port's own kernel, ops/mesh.py::density_grid).  For a
// grid point p of z-slab s and each Gaussian i of the slab's candidate list
// (chosen on the host exactly as JAX chooses them):
//   d = p - mu_i,
//   power = -1/2 (A dx² + D dy² + F dz²) - B dx dy - C dx dz - E dy dz
//   with (A, B, C, D, E, F) the inverse covariance entries,
//   value(p) = sum_i opa_i * (power <= 0 ? exp(power) : 0),
// written to grid[x][y][z] ([res, res, res] f32, JAX's [x, y, z] order).
// Grid coordinates come from the host's np.linspace array, so they are the
// same floats as JAX's.  Slabs with no candidates come out 0.
//
// What bounds it on an H100: f32 arithmetic.  At resolution 256 a slab is one
// z-plane of 65,536 points against up to 8,192 Gaussians: up to 1.4e11
// (point, Gaussian) pairs of ~25 f32 operations and one expf each, ~50 ms
// at the 67 TFLOP/s f32 peak, while the bytes are the 64 MB grid and a
// few MB of lists.  No tensor-core form keeps the f32 bars (an expanded
// quadratic loses digits to cancellation near each Gaussian).
//
// Design (simple first; one launch for all slabs):
//   * one thread per grid point, 256 threads a block, blockIdx.y the slab;
//   * the slab's Gaussians are staged through shared memory in chunks of
//     256 (each thread loads one: its index, then 10 floats as 3 float4s),
//     read back as broadcasts;
//   * f32 accumulation in list order; IEEE expf (the library builds
//     without --use_fast_math);
//   * a pair whose power is below -104 is skipped: its expf is 0 in f32
//     (e^-104 is under half the smallest denormal), so the sum is the
//     same; most pairs are far from the Gaussian, and a warp skips the
//     expf when none of its lanes needs it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = THREADS;        // Gaussians staged per round
constexpr float SKIP_BELOW = -104.0f;

__global__ void __launch_bounds__(THREADS)
density_grid_kernel(const float* __restrict__ lin,
                    const int* __restrict__ slab_z,
                    const int* __restrict__ idx,
                    const int* __restrict__ counts,
                    const float* __restrict__ xyz,
                    const float* __restrict__ inv,
                    const float* __restrict__ opa,
                    float* __restrict__ grid, int res, int max_per_block) {
  __shared__ float4 sg[CHUNK * 3];
  const int slab = blockIdx.y;
  const int z0 = slab_z[2 * slab];
  const int z1 = slab_z[2 * slab + 1];
  const long long plane = static_cast<long long>(res) * res;
  const long long npts = (z1 - z0) * plane;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS;
  if (first >= npts) return;          // uniform over the block
  const long long p = first + threadIdx.x;
  const bool valid = p < npts;
  // points of a slab in JAX's meshgrid order: z, then y, then x fastest
  const int xi = valid ? static_cast<int>(p % res) : 0;
  const int yi = valid ? static_cast<int>((p / res) % res) : 0;
  const int zi = valid ? z0 + static_cast<int>(p / plane) : z0;
  const float px = lin[xi], py = lin[yi], pz = lin[zi];

  const int n = counts[slab];
  const int* list = idx + static_cast<long long>(slab) * max_per_block;
  float acc = 0.0f;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();                  // the previous chunk is consumed
    if (threadIdx.x < m) {
      const long long g = list[c0 + threadIdx.x];
      const float* gi = inv + 6 * g;
      sg[3 * threadIdx.x] = make_float4(xyz[3 * g], xyz[3 * g + 1],
                                        xyz[3 * g + 2], opa[g]);
      sg[3 * threadIdx.x + 1] = make_float4(gi[0], gi[1], gi[2], gi[3]);
      sg[3 * threadIdx.x + 2] = make_float4(gi[4], gi[5], 0.0f, 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 a = sg[3 * j];      // mu x, y, z, opacity
      const float4 b = sg[3 * j + 1];  // A, B, C, D
      const float4 c = sg[3 * j + 2];  // E, F
      const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
      const float power = -0.5f * (b.x * (dx * dx) + b.w * (dy * dy)
                                   + c.y * (dz * dz))
                          - b.y * dx * dy - b.z * dx * dz - c.x * dy * dz;
      if (power <= 0.0f && power > SKIP_BELOW) acc += a.w * expf(power);
    }
  }
  if (valid) grid[(static_cast<long long>(xi) * res + yi) * res + zi] = acc;
}

}  // namespace

// lin [res] f32; slab_z [n_slabs, 2] int32 (z0, z1); idx [n_slabs,
// max_per_block] int32 (rows past counts[s] unread); counts [n_slabs]
// int32; xyz [N, 3], inv [N, 6], opa [N] f32; grid [res, res, res] f32,
// every element written.  slab_rows: the most z rows of any slab.
extern "C" int odgs_density_grid(const void* lin, const void* slab_z,
                                 const void* idx, const void* counts,
                                 const void* xyz, const void* inv,
                                 const void* opa, void* grid, int res,
                                 int n_slabs, int max_per_block,
                                 int slab_rows, void* stream) {
  if (n_slabs == 0 || res == 0) return 0;
  const long long pts = static_cast<long long>(slab_rows) * res * res;
  dim3 blocks(static_cast<unsigned>((pts + THREADS - 1) / THREADS),
              static_cast<unsigned>(n_slabs));
  density_grid_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lin), static_cast<const int*>(slab_z),
      static_cast<const int*>(idx), static_cast<const int*>(counts),
      static_cast<const float*>(xyz), static_cast<const float*>(inv),
      static_cast<const float*>(opa), static_cast<float*>(grid), res,
      max_per_block);
  return static_cast<int>(cudaGetLastError());
}
