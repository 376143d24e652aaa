// Gaussian density field of the mesh export, evaluated for every grid point.
//
// Replaces the per-slab XLA fusion `eval_block` of the JAX package's
// open_diffusiongs_tpu/ops/mesh.py::gaussian_density_grid (:312-322; not a
// Pallas kernel: the port's own kernel, ops/mesh.py::density_grid).  For a
// grid point p of z-slab s and each Gaussian i of the slab's candidate list
// (chosen exactly as JAX chooses them, ops/mesh.py::slab_select):
//   d = p - mu_i,
//   power = -1/2 (A dx² + D dy² + F dz²) - B dx dy - C dx dz - E dy dz
//   with (A, B, C, D, E, F) the inverse covariance entries,
//   value(p) = sum_i opa_i * (power <= 0 ? exp(power) : 0),
// in list order, in f32, written to grid[x][y][z] ([res, res, res] f32,
// JAX's [x, y, z] order).  Grid coordinates come from np.linspace's array,
// so they are the same floats as JAX's.  Slabs with no candidates come out
// 0.  IEEE expf (the library builds without --use_fast_math) on the FP32
// pipe: no tensor-core form keeps the f32 bars (an expanded quadratic loses
// digits to cancellation near each Gaussian).
//
// What bounded the first design (one thread per point, every pair of the
// list evaluated): f32 arithmetic on pairs these inputs do not need.  At
// resolution 256 a slab is one z-plane of 65,536 points against up to 8,192
// Gaussians, 1.3e11 pairs of ~25 f32 operations; yet a pair adds nothing
// where its power is below -104 (expf is 0 there in f32: e^-104 is under
// half the smallest denormal), and a Gaussian of the trained statistics
// (normalised sigma ~0.01) reaches -104 within ~14 sigma of its centre, a
// few percent of the plane.  Each of the plane's 256 blocks also gathered
// the list again from scattered xyz / inv addresses.
//
// Design (one launch for all slabs):
//   * a block owns a 32 x 16 tile of one z-plane of one slab
//     (blockIdx.x the tile, .y the plane in the slab, .z the slab); a
//     warp owns 32 x 4 points, a thread one x and 4 y's in registers, so
//     each staged Gaussian is read from shared memory once for 4 points;
//   * the slab's list arrives as packed records (mu, opacity | A, B, C, D |
//     E, F, ext_x, ext_y: 48 bytes, ops/mesh.py::density_records), staged
//     by a double-buffered cp.async ring of 128 records, 16-byte copies on
//     consecutive addresses;
//   * an exact cull: each chunk's records are tested against the tile's
//     box (one record a thread) and the survivors compacted in list order
//     (ballot + prefix); the block evaluates only the survivors.  ext_x /
//     ext_y (ops/mesh.py::cull_extents) are conservative for this file's
//     f32 power: a pair with |dx| > ext_x or |dy| > ext_y has power < -104,
//     and rounding is monotone, so the tile's point nearest mu on each axis
//     decides for the whole tile.  A culled pair would have added nothing,
//     so the grid is bit-identical to the grid without the cull (`cull` =
//     0, the check chip_smoke.py makes; nothing on the serving path sets
//     it), and the summation order stays the list's;
//   * f32 accumulation in list order; a pair whose power is not in
//     (-104, 0] adds nothing, and a warp skips the expf when none of its
//     lanes needs it.
// What bounds it now (chip_smoke.py 15a; NVIDIA H100 80GB HBM3, 700 W):
//   * phase 5's 256^2 asset at 256 (large, overlapping Gaussians): 2.56e8
//     (tile, record) box tests, 1.15e11 evaluated pairs, 8.78e10 live ones
//     (power in (-104, 0]) of the lists' 1.31e11.  The cull keeps most
//     pairs, and the FP32 pipe bounds the kernel (103 ms; 112 without the
//     cull; 32.8 ms for the live pairs at 25 f32 operations each);
//   * the 512^2 trained-statistics Gaussians at 256: 2.64e8 box tests,
//     5.47e9 evaluated pairs, 7.11e8 live ones of 1.35e11 (5.6 ms; 82
//     without the cull; 0.27 ms for the live pairs).  A tile evaluates
//     each survivor at all its 512 points, 7.7x the live pairs, and every
//     tile streams its slab's whole list (12.7 GB of records through L2);
//   * the 20k shell at 128: 8.8e6 box tests, 1.32e9 evaluated, 5.18e8
//     live pairs of 4.49e9 (1.5 ms; 0.19 ms for the live pairs).
// With `counters` the kernel adds its live pairs, evaluated pairs and box
// tests (counters[0..2]), which chip_smoke.py prints beside the bound.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;                 // tile width in x: a warp's lanes
constexpr int PY = 4;                  // y points of a thread
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TY = PY * WARPS;         // tile height in y
constexpr int CHUNK = THREADS;         // records staged per round
constexpr int REC4 = 3;                // float4s of a record
constexpr float SKIP_BELOW = -104.0f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// m records (3m float4s) of `src` into `dst`, one cp.async group (empty
// when m is 0): thread t copies float4s t, t + THREADS, t + 2 THREADS.
__device__ __forceinline__ void stage_chunk(float4* dst, const float4* src,
                                            int m) {
  for (int i = threadIdx.x; i < m * REC4; i += THREADS)
    cp_async16(dst + i, src + i);
  cp_async_commit();
}

// Distance from v to [lo, hi] as the kernel's f32 offsets see it: rounding
// is monotone, so no point of the interval is nearer.
__device__ __forceinline__ float gap(float v, float lo, float hi) {
  return v < lo ? lo - v : (v > hi ? v - hi : 0.0f);
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
density_grid_kernel(const float* __restrict__ lin,
                    const int* __restrict__ slab_z,
                    const int* __restrict__ counts,
                    const float4* __restrict__ rec,
                    float* __restrict__ grid, int res, int max_per_block,
                    int tiles_x, int cull,
                    unsigned long long* __restrict__ counters) {
  __shared__ float4 ring[2][CHUNK * REC4];
  __shared__ int keep[CHUNK];
  __shared__ int warp_hits[WARPS];
  const int slab = blockIdx.z;
  const int z = slab_z[2 * slab] + static_cast<int>(blockIdx.y);
  if (z >= slab_z[2 * slab + 1]) return;        // uniform over the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int xi = x0 + lane, yi = y0 + warp * PY;
  const float px = lin[min(xi, res - 1)], pz = lin[z];
  float py[PY], acc[PY];
#pragma unroll
  for (int q = 0; q < PY; ++q) {
    py[q] = lin[min(yi + q, res - 1)];
    acc[q] = 0.0f;
  }
  // the tile's box: its points' extreme coordinates (lin increases)
  const float bx0 = lin[x0], bx1 = lin[min(x0 + TX, res) - 1];
  const float by0 = lin[y0], by1 = lin[min(y0 + TY, res) - 1];
  const int valid_pts = xi < res ? max(0, min(PY, res - yi)) : 0;
  unsigned long long live = 0, evaluated = 0;

  const int n = counts[slab];
  const float4* list = rec + static_cast<long long>(slab) * max_per_block
                       * REC4;
  const int chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks > 0) stage_chunk(ring[0], list, min(CHUNK, n));
  for (int c = 0; c < chunks; ++c) {
    const int m = min(CHUNK, n - c * CHUNK);
    const int next = (c + 1) * CHUNK;
    stage_chunk(ring[(c + 1) & 1],
                list + static_cast<long long>(next) * REC4,
                max(0, min(CHUNK, n - next)));
    cp_async_wait1();                  // chunk c has landed (this thread's)
    __syncthreads();                   // ... and every thread's
    const float4* s = ring[c & 1];
    bool hit = threadIdx.x < m;
    if (hit && cull) {
      const float4 a = s[REC4 * threadIdx.x];       // mu, opacity
      const float4 e = s[REC4 * threadIdx.x + 2];   // E, F, ext_x, ext_y
      hit = !(gap(a.x, bx0, bx1) > e.z || gap(a.y, by0, by1) > e.w);
    }
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(hits);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      base += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) keep[base + __popc(hits & ((1u << lane) - 1u))] = threadIdx.x;
    __syncthreads();
    for (int k = 0; k < total; ++k) {
      const int j = keep[k];
      const float4 a = s[REC4 * j];        // mu x, y, z, opacity
      const float4 b = s[REC4 * j + 1];    // A, B, C, D
      const float4 e = s[REC4 * j + 2];    // E, F
      const float dx = px - a.x, dz = pz - a.z;
#pragma unroll
      for (int q = 0; q < PY; ++q) {
        const float dy = py[q] - a.y;
        const float power = -0.5f * (b.x * (dx * dx) + b.w * (dy * dy)
                                     + e.y * (dz * dz))
                            - b.y * dx * dy - b.z * dx * dz - e.x * dy * dz;
        if (power <= 0.0f && power > SKIP_BELOW) {
          acc[q] += a.w * expf(power);
          if (COUNT && q < valid_pts) ++live;
        }
      }
    }
    if (COUNT) evaluated += static_cast<unsigned long long>(total)
                            * valid_pts;
    __syncthreads();                   // the stage is consumed
  }
#pragma unroll
  for (int q = 0; q < PY; ++q)
    if (q < valid_pts)
      grid[(static_cast<long long>(xi) * res + yi + q) * res + z] = acc[q];
  if (COUNT) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      live += __shfl_down_sync(0xffffffffu, live, off);
      evaluated += __shfl_down_sync(0xffffffffu, evaluated, off);
    }
    if (lane == 0) {
      atomicAdd(counters, live);
      atomicAdd(counters + 1, evaluated);
    }
    if (threadIdx.x == 0)
      atomicAdd(counters + 2, static_cast<unsigned long long>(n));
  }
}

}  // namespace

// lin [res] f32; slab_z [n_slabs, 2] int32 (z0, z1); counts [n_slabs]
// int32; rec [n_slabs, max_per_block, 12] f32 packed records (rows past
// counts[s] unread); grid [res, res, res] f32, every element written.
// slab_rows: the most z rows of any slab.  cull: 0 evaluates every pair
// of the lists.  counters: null, or 3 int64 (live pairs, evaluated pairs,
// box tests) that the launch adds to.
extern "C" int odgs_density_grid(const void* lin, const void* slab_z,
                                 const void* counts, const void* rec,
                                 void* grid, int res, int n_slabs,
                                 int max_per_block, int slab_rows, int cull,
                                 void* counters, void* stream) {
  if (n_slabs == 0 || res == 0) return 0;
  const int tiles_x = (res + TX - 1) / TX, tiles_y = (res + TY - 1) / TY;
  const dim3 blocks(static_cast<unsigned>(tiles_x * tiles_y),
                    static_cast<unsigned>(slab_rows),
                    static_cast<unsigned>(n_slabs));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lin);
  const auto* sz = static_cast<const int*>(slab_z);
  const auto* ct = static_cast<const int*>(counts);
  const auto* r = static_cast<const float4*>(rec);
  auto* g = static_cast<float*>(grid);
  auto* cn = static_cast<unsigned long long*>(counters);
  if (cn)
    density_grid_kernel<true><<<blocks, THREADS, 0, st>>>(
        l, sz, ct, r, g, res, max_per_block, tiles_x, cull, cn);
  else
    density_grid_kernel<false><<<blocks, THREADS, 0, st>>>(
        l, sz, ct, r, g, res, max_per_block, tiles_x, cull, cn);
  return static_cast<int>(cudaGetLastError());
}
