// Per-tile alpha blend of the Gaussian rasterizer, backward.
//
// Replaces the TPU Pallas kernel open_diffusiongs_tpu/ops/blend_kernel.py::
// blend_bwd_pallas (body _blend_bwd_kernel, :117-218): per-candidate
// gradient rows dg [T, K, 10] of the blend of blend_fwd.cu, for cotangents
// of its three outputs (t_fin, acc_c, acc_d).  Same algebra as the TPU
// kernel: the candidates are re-walked in FORWARD order, recomputing the
// forward state exactly (transmittance T_i, skip, early stop), with one
// per-pixel running sum in place of the back-to-front suffix sums of the
// reference backward (backward.cu:399-557), which would divide by T:
//   A_i = dC . rgb_i + dD z_i,   Q_i = sum_{j<=i} w_j A_j,
//   e   = dC . acc_c + dD acc_d + dT t_fin   (from the forward outputs),
//   dL/dalpha_i = T_i A_i - (e - Q_i) / (1 - alpha_i)   for contributors,
// and through alpha_i = min(0.99, o_i exp(power_i)) only while
// o_i exp(power_i) < 0.99 (the clamp's gradient gate).  Skipped, stopping
// and post-stop candidates get zero rows, as do slots >= counts[t].
//
// What bounds it on an H100: the sums over a tile's 256 pixels of each
// candidate's 10 gradient entries.  Ten 5-step butterflies a candidate
// (50 shuffles, at 32 lanes a clock per SM) cost more than the pair
// arithmetic itself; then the forward's costs: scattered 40-byte row
// loads, and warps walking until the whole tile has stopped.  Tensor
// cores play no part (serial per-pixel f32 algebra with an expf).
//
// Design (blend.cuh holds the pieces shared with the forward):
//   * the forward's structure: 8 consumer warps, each on its 8x4 pixel
//     rectangle with its own 2-stage cp.async ring of candidate rows and
//     the forward's cull; a warp's walk ends at the largest end slot
//     (n_end, the forward's output) among its lanes;
//   * reduce-scatter across lanes: a warp takes the chunk's candidates 3
//     at a time, their gradient rows straight into 30 of 32 registers a
//     lane, and folds them with 16+8+4+2+1 = 31 shuffles, after which lane
//     l holds the warp's sum of value l: ~10 shuffles a candidate instead
//     of 50.  A batch no lane contributes to costs no reduction, a culled
//     candidate no work;
//   * a 2-stage ring of warp partials in shared memory, [8 warps][32
//     candidates][10], guarded by mbarriers: a warp arrives on `full` once
//     its partials of a chunk are written (with a mask of the candidates
//     it wrote), and the ninth warp sums the 8 partials of each row in
//     fixed warp order, writes the chunk's 320 values of dg in one
//     coalesced pass and arrives on `empty`.  Every sum has a fixed
//     order, so dg is bit for bit the same on every run.  Slots past the
//     tile's last walked candidate are zeroed in a coalesced pass by the
//     whole block;
//   * the forward's per-pair arithmetic (blend.cuh::blend_pair), so T_i is
//     rebuilt bit for bit; within a batch the alphas are formed first,
//     branch-free, then T, Q and the rows in order.

#include "blend.cuh"
#include "hopper.cuh"

namespace {

using namespace odgs_blend;
using odgs::mbar_arrive;
using odgs::mbar_init;
using odgs::mbar_wait;

constexpr int STAGES = 2;    // candidate-row ring of each warp
constexpr int PSTAGES = 2;   // ring of warp partials
constexpr int NW = TILE_WARPS;   // consumer warps; warp NW reduces
constexpr int THREADS = (NW + 1) * 32;
constexpr int BATCH = 3;     // candidates a reduce-scatter folds (30 of 32)
static_assert(BATCH == 3, "three candidates fill 30 of a fold's 32 values");

struct Smem {
  float ring[NW][STAGES][CH * NA];
  float part[PSTAGES][NW][CH * NA];
  unsigned written[PSTAGES][NW];   // candidates of the chunk each warp wrote
  uint64_t full[PSTAGES], empty[PSTAGES];
  int wend[NW];
  int lists[NW][CH];   // a chunk's candidates each warp walks
};

// One halving step of the reduce-scatter: v[0, OFF) keeps the half of
// v[0, 2 OFF) that lane bit OFF selects, summed with the partner's.
template <int OFF>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// v[i] summed over the warp's lanes lands in lane i (31 shuffles).
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(THREADS)
blend_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ idx,
                 const int* __restrict__ counts,
                 const int* __restrict__ n_end, int k, int tiles_x,
                 const float* __restrict__ t_fin,
                 const float* __restrict__ acc_c,
                 const float* __restrict__ acc_d,
                 const float* __restrict__ d_tfin,
                 const float* __restrict__ d_accc,
                 const float* __restrict__ d_accd, float* __restrict__ dg) {
  __shared__ __align__(16) Smem s;
  const int t = blockIdx.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int count = counts[t];
  const int* tidx = idx + static_cast<long long>(t) * k;
  float* out = dg + static_cast<long long>(t) * k * NA;
  const int tx = (t % tiles_x) * TILE, ty = (t / tiles_x) * TILE;
  const int p = rect_pixel(w % NW, lane);
  const long long o = static_cast<long long>(t) * PPT + p;

  // the end slot of each lane's walk, and the warp's (its largest)
  int lend = 0;
  if (w < NW) {
    lend = n_end ? min(n_end[o], count) : count;
    const int wend = __reduce_max_sync(FULL, lend);
    if (lane == 0) s.wend[w] = wend;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < PSTAGES; ++i) {
      mbar_init(&s.full[i], NW * 32);
      mbar_init(&s.empty[i], 32);
    }
  }
  __syncthreads();
  int tend = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) tend = max(tend, s.wend[i]);
  const int nct = (tend + CH - 1) / CH;   // chunks walked by the tile
  for (long long c = static_cast<long long>(nct) * CH * NA + threadIdx.x;
       c < static_cast<long long>(k) * NA; c += THREADS)
    out[c] = 0.f;

  if (w == NW) {   // the reducer: fixed-order sums of the warp partials
    for (int j = 0; j < nct; ++j) {
      const int ps = j % PSTAGES;
      mbar_wait(&s.full[ps], (j / PSTAGES) & 1);
      unsigned wr[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) wr[i] = s.written[ps][i];
#pragma unroll
      for (int r = 0; r < NA; ++r) {
        const int e = r * 32 + lane, row = e / NA;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NW; ++i)
          if ((wr[i] >> row) & 1u) acc += s.part[ps][i][e];
        if (j * CH + row < k)
          out[static_cast<long long>(j) * CH * NA + e] = acc;
      }
      mbar_arrive(&s.empty[ps]);
    }
    return;
  }

  const float px = static_cast<float>(tx + p % TILE);
  const float py = static_cast<float>(ty + p / TILE);
  const float rx0 = static_cast<float>(tx + (w % 2) * RECT_W);
  const float ry0 = static_cast<float>(ty + (w / 2) * RECT_H);
  const float rx1 = rx0 + (RECT_W - 1), ry1 = ry0 + (RECT_H - 1);
  const float dc0 = d_accc[3 * o], dc1 = d_accc[3 * o + 1],
              dc2 = d_accc[3 * o + 2], dd = d_accd[o];
  const float e = (dc0 * acc_c[3 * o] + dc1 * acc_c[3 * o + 1] +
                   dc2 * acc_c[3 * o + 2]) +
                  dd * acc_d[o] + d_tfin[o] * t_fin[o];
  const int wend = s.wend[w];
  const int wch = (wend + CH - 1) / CH;
  float* mine = &s.ring[w][0][0];
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c)
    stage_rows(mine + c * CH * NA, packed,
               slot_row(tidx, c * CH, wend, lane), c * CH, wend, lane);
  int next = slot_row(tidx, (STAGES - 1) * CH, wend, lane);

  float tr = 1.f, q = 0.f;
  bool done = false, wdone = false;
  for (int j = 0; j < nct; ++j) {
    const int ps = j % PSTAGES;
    // the partial slab of chunk j - PSTAGES must be summed before this
    // chunk's partials go there: waited for at the first write, so the
    // walk of chunk j overlaps the reducer
    bool claimed = j < PSTAGES;
    const auto claim = [&]() {
      if (!claimed) mbar_wait(&s.empty[ps], (j / PSTAGES - 1) & 1);
      claimed = true;
    };
    unsigned written = 0;
    if (j < wch && !wdone) {
      const int ahead = j + STAGES - 1;
      stage_rows(mine + (ahead % STAGES) * CH * NA, packed, next, ahead * CH,
                 wend, lane);
      next = slot_row(tidx, (ahead + 1) * CH, wend, lane);
      cp_async_wait<STAGES - 1>();
      __syncwarp();
      const float* st = mine + (j % STAGES) * CH * NA;
      const int base = j * CH;
      float* part = s.part[ps][w];
      const int n = compact(
          __ballot_sync(FULL, base + lane < wend &&
                                  !misses_rect(st + lane * NA, rx0, ry0,
                                               rx1, ry1)),
          s.lists[w], lane);
      for (int b0 = 0; b0 < n; b0 += BATCH) {
        // BATCH candidates: their alphas (independent of T) together and
        // branch-free, then T, Q and the gradient rows through them in
        // order, each row straight into its 10 of the 32 values the
        // reduce-scatter folds
        int ci[BATCH];
        float gx[BATCH], gy[BATCH], ge[BATCH], go[BATCH], al[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          ci[b] = b0 + b < n ? s.lists[w][b0 + b] : -1;
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const Pair pr = blend_pair(st + max(ci[b], 0) * NA, px, py);
          al[b] = ci[b] >= 0 && base + ci[b] < lend ? pr.alpha : 0.f;
          gx[b] = pr.dx;
          gy[b] = pr.dy;
          ge[b] = pr.gexp;
          go[b] = pr.og;
        }
        float v[32];
        v[30] = v[31] = 0.f;
        unsigned wmask = 0;   // candidates some lane contributes to
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int i = max(ci[b], 0);
          const float alpha = al[b];
          const bool valid = !done && alpha != 0.f;
          const float test_t = tr * (1.f - alpha);
          const bool stop = valid && test_t < EARLY_STOP_T;
          // the stopping candidate does not contribute
          const bool live = valid && !stop;
          done = done || stop || (ci[b] >= 0 && base + i >= lend);
          const float2* a = reinterpret_cast<const float2*>(st + i * NA);
          const float2 ab = a[1], cr = a[2], gb = a[3], oz = a[4];
          const float dx = gx[b], dy = gy[b];
          const float w8 = alpha * tr;
          const float big_a =
              cr.y * dc0 + gb.x * dc1 + gb.y * dc2 + oz.y * dd;
          q = live ? q + w8 * big_a : q;
          const float dalpha = tr * big_a - (e - q) / (1.f - alpha);
          const bool unclamped = go[b] < ALPHA_MAX;
          const float dpow = unclamped ? dalpha * alpha : 0.f;
          float gr[NA];
          gr[0] = dpow * (-(ab.x * dx + ab.y * dy));   // mean x
          gr[1] = dpow * (-(cr.x * dy + ab.y * dx));   // mean y
          gr[2] = dpow * (-0.5f * dx * dx);            // conic a
          gr[3] = dpow * (-dx * dy);                   // conic b
          gr[4] = dpow * (-0.5f * dy * dy);            // conic c
          gr[5] = w8 * dc0;
          gr[6] = w8 * dc1;
          gr[7] = w8 * dc2;
          gr[8] = unclamped ? dalpha * ge[b] : 0.f;    // opacity
          gr[9] = w8 * dd;                             // depth
#pragma unroll
          for (int c = 0; c < NA; ++c) v[b * NA + c] = live ? gr[c] : 0.f;
          tr = live ? test_t : tr;
          if (__any_sync(FULL, live)) wmask |= 1u << i;
        }
        if (wmask) {
          claim();
          const float r = reduce_scatter(v, lane);
          const int g = lane / NA;   // this lane's candidate of the batch
          const int c = g == 0 ? ci[0] : g == 1 ? ci[1] : ci[2];
          if (lane < BATCH * NA && c >= 0 && ((wmask >> c) & 1u))
            part[c * NA + lane % NA] = r;
          written |= wmask;
        }
        if (__all_sync(FULL, done)) break;
      }
      wdone = __all_sync(FULL, done);
      __syncwarp();   // every lane has read chunk j (and the list) before
                      // they refill
    }
    claim();
    if (lane == 0) s.written[ps][w] = written;
    mbar_arrive(&s.full[ps]);
  }
  cp_async_wait_all();
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// packed [N+1, 10] f32, idx [num_tiles, k] i32, counts [num_tiles] i32
// (counts[t] <= k), n_end [num_tiles, 256] i32 from the forward (or null:
// every pixel's walk is bounded by counts[t]); forward outputs and their
// cotangents t_fin / d_tfin [num_tiles, 256], acc_c / d_accc
// [num_tiles, 256, 3], acc_d / d_accd [num_tiles, 256]; output dg
// [num_tiles, k, 10]; all contiguous f32.
extern "C" int odgs_blend_bwd(const void* packed, const void* idx,
                              const void* counts, const void* n_end,
                              int num_tiles, int k, int tiles_x,
                              const void* t_fin, const void* acc_c,
                              const void* acc_d, const void* d_tfin,
                              const void* d_accc, const void* d_accd,
                              void* dg, void* stream) {
  if (num_tiles == 0) return 0;
  blend_bwd_kernel<<<num_tiles, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const int*>(counts), static_cast<const int*>(n_end), k,
      tiles_x, static_cast<const float*>(t_fin),
      static_cast<const float*>(acc_c), static_cast<const float*>(acc_d),
      static_cast<const float*>(d_tfin), static_cast<const float*>(d_accc),
      static_cast<const float*>(d_accd), static_cast<float*>(dg));
  return static_cast<int>(cudaGetLastError());
}
