// Exact non-causal multi-head attention forward on the packed DiT layout.
//
// Replaces the TPU Pallas kernel open_diffusiongs_tpu/ops/attention.py::
// flash_mha_packed (body _fwd_kernel_packed, :221-290).  Same math:
//   q/k/v [b, Lp, h*dh] bf16, head h in columns h*dh .. h*dh+dh-1;
//   q is pre-scaled by dh^-1/2 * log2(e) and rounded back to bf16;
//   the online softmax runs in base 2 (exp2f) with f32 running max / sum;
//   keys >= l_real are excluded (their K and V rows are zeroed in shared
//   memory and their scores set to -inf, so pad-row garbage cannot leak);
//   output in bf16, pad rows (>= l_real) are garbage like on the TPU.
// With a non-null `lse` (the training forward, body _fwd_kernel_packed_stats
// :212) it also writes the base-2 log-sum-exp m + log2(l) of every real row
// into lse [b, Lp, h] f32 (pad rows get 0): the one forward fact the
// backward (flash_attn_bwd.cu) rebuilds P from.  One template flag, so the
// stats-free sampling launch is unchanged.
// With `SMAX` (body _fwd_kernel_packed_smax :146-210, flash_mha_packed(
// scalar_max=True)) the running max is one scalar per (64-row q tile, head)
// instead of one per row: each key tile's max is reduced over the whole
// block (warp shuffles, then shared memory across the 4 warps).  As on the
// TPU, the zeroed pad keys (score 0) count toward that max when
// Lp > l_real, and so do the q tile's pad rows (< Lp); rows past Lp are
// not part of the tile.  A row whose scores all sit > ~126 below the
// block max underflows to 0 (denominator clamped at 1e-30, as :207).
// The TPU kernel's V "ones column" (an MXU trick for the row sum) is not
// carried over: the row sum is accumulated in registers.
//
// Design (FlashAttention-2 shape, simple first version): one 128-thread
// block per (64-row q tile, head, batch); each of the 4 warps owns 16 q
// rows.  Q fragments stay in registers; 64-key K and V tiles are staged
// through shared memory (V transposed, so its mma B fragments are 32-bit
// loads).  Q·Kᵀ and P·V run on the tensor cores with mma.sync m16n8k16
// (bf16 in, f32 accumulate).  The score accumulator of two adjacent n8
// tiles is exactly the A-fragment layout of the P·V mma, so P goes from
// registers to the tensor cores without touching shared memory; P is
// rounded to bf16 there (the TPU kernel keeps P·V in f32), the row sum uses
// the unrounded f32 P.
//
// What bounds it: at the 256^2 flagship shape (Lp = l_real = 4098, h = 16,
// dh = 64) one call is 4·L²·dh·h ≈ 68.8 GFLOP of tensor-core work on
// ~25 MB of q/k/v, far above the H100's ~295 FLOP/byte ridge, so the bound
// is tensor-core issue rate.  This first version leaves most of it on the
// table: no cp.async/TMA pipelining (each K/V tile load is exposed behind a
// __syncthreads), mma.sync instead of wgmma, and a transposing V store with
// shared-memory bank conflicts.  Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH, bool STATS, bool SMAX>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int lp, int h, int l_real,
                 float scale, long long q_sb, long long q_sl, long long k_sb,
                 long long k_sl, long long v_sb, long long v_sl) {
  constexpr int LDQ = DH + 8;      // padded Qs/Ks row: conflict-free frags
  constexpr int LDV = BK + 8;      // padded row of the transposed V tile
  constexpr int CPR = DH / 8;      // 16-byte chunks per head row
  constexpr int KSTEPS = DH / 16;  // mma k-steps of Q·Kᵀ (1 at DH = 16)
  constexpr int DTILES = DH / 8;   // mma n-tiles of the output row
  static_assert(DH % 16 == 0 && DH <= 64, "DH in {16, 32, 64}");
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LDQ];
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDQ];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * LDV];
  __shared__ float red[2][NTHREADS / 32];   // SMAX: per-warp tile maxima

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma group / thread-in-group
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const int col0 = head * DH;
  const __nv_bfloat16* qb = q + bi * q_sb + col0;
  const __nv_bfloat16* kb = k + bi * k_sb + col0;
  const __nv_bfloat16* vb = v + bi * v_sb + col0;

  // Q tile, pre-scaled by dh^-1/2 * log2(e) and rounded back to bf16 (as
  // the TPU kernel does); rows past Lp are zero.
  for (int c = tid; c < BQ * CPR; c += NTHREADS) {
    const int r = c / CPR, c8 = (c % CPR) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < lp) {
      raw = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_sl + c8);
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p2[i]);
        p2[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(&qs[r * LDQ + c8]) = raw;
  }
  __syncthreads();

  uint32_t qf[KSTEPS][4];
  {
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qf[kk][0] = ld32(&qs[r0 * LDQ + c]);
      qf[kk][1] = ld32(&qs[(r0 + 8) * LDQ + c]);
      qf[kk][2] = ld32(&qs[r0 * LDQ + c + 8]);
      qf[kk][3] = ld32(&qs[(r0 + 8) * LDQ + c + 8]);
    }
  }

  // Each thread owns rows g and g+8 of its warp's 16: running max, sum and
  // the output accumulator fragments (row g in [0..1], row g+8 in [2..3]).
  // SMAX: both entries hold the block's one max, which starts at the pad
  // keys' score 0 when there are pad keys (Lp > l_real).
  const float m0 = (SMAX && lp > l_real) ? 0.f : -INFINITY;
  float m_run[2] = {m0, m0};
  const int r0 = q0 + warp * 16 + g;
  float l_run[2] = {0.f, 0.f};
  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j] = 0.f;

  const int n_kt = (l_real + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * CPR; c += NTHREADS) {
      const int r = c / CPR, c8 = (c % CPR) * 8;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (k0 + r < l_real) {
        kr = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_sl + c8);
        vr = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_sl + c8);
      }
      *reinterpret_cast<uint4*>(&ks[r * LDQ + c8]) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(c8 + i) * LDV + r] = ve[i];
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + g) * LDQ + kk * 16 + 2 * t4];
        mma16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    if (k0 + BK > l_real) {   // ragged last tile: keys >= l_real drop out
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + nt * 8 + 2 * t4 + (j & 1) >= l_real) s[nt][j] = -INFINITY;
    }
    if (SMAX && q0 + BQ > lp) {   // rows past Lp are not part of the block
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r0 + 8 * (j >> 1) >= lp) s[nt][j] = -INFINITY;
    }

    // Online softmax in base 2.  Every processed tile holds >= 1 real key,
    // so the new max is finite and exp2f(-inf - m) = 0 on the first tile.
    float mt0 = m_run[0], mt1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mt0 = fmaxf(mt0, fmaxf(s[nt][0], s[nt][1]));
      mt1 = fmaxf(mt1, fmaxf(s[nt][2], s[nt][3]));
    }
    if (SMAX) {   // one max over the block: warp, then the 4 warps
      mt0 = fmaxf(mt0, mt1);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, off));
      if (lane == 0) red[kt & 1][warp] = mt0;
      __syncthreads();   // red[kt & 1] is rewritten two tiles later, after
                         // the next tile's two barriers
#pragma unroll
      for (int w = 0; w < NTHREADS / 32; ++w) mt0 = fmaxf(mt0, red[kt & 1][w]);
      mt1 = mt0;
    } else {
      mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
      mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
      mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
    }
    const float a0 = exp2f(m_run[0] - mt0), a1 = exp2f(m_run[1] - mt1);
    m_run[0] = mt0;
    m_run[1] = mt1;
    l_run[0] *= a0;
    l_run[1] *= a1;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mt0);
      s[nt][1] = exp2f(s[nt][1] - mt0);
      s[nt][2] = exp2f(s[nt][2] - mt1);
      s[nt][3] = exp2f(s[nt][3] - mt1);
      l_run[0] += s[nt][0] + s[nt][1];
      l_run[1] += s[nt][2] + s[nt][3];
    }

    // O += P·V: the score fragments of n-tiles 2j, 2j+1 are the A fragment
    // of k-step j.
#pragma unroll
    for (int kj = 0; kj < BK / 16; ++kj) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kj][0], s[2 * kj][1]),
                              pack_bf16x2(s[2 * kj][2], s[2 * kj][3]),
                              pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                              pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* vr = &vt[(dt * 8 + g) * LDV + kj * 16 + 2 * t4];
        mma16816(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // Row sums live spread over the 4 threads of a group.
  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  // Clamped as on the TPU (:73, :207): only a SMAX row can underflow to 0.
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o_sl = (long long)h * DH;
  __nv_bfloat16* ob = o + (long long)bi * lp * o_sl + col0;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (r0 < lp)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_sl + c) =
          pack_bf16x2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r0 + 8 < lp)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * o_sl + c) =
          pack_bf16x2(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (STATS && t4 == 0) {   // m and l are shared by the 4 threads of a group
    float* lb = lse + (long long)bi * lp * h + head;
    if (r0 < lp) lb[(long long)r0 * h] = r0 < l_real ? m_run[0] + log2f(l0) : 0.f;
    if (r0 + 8 < lp)
      lb[(long long)(r0 + 8) * h] = r0 + 8 < l_real ? m_run[1] + log2f(l1) : 0.f;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int lp, int h, int l_real, float scale, long long q_sb,
           long long q_sl, long long k_sb, long long k_sl, long long v_sb,
           long long v_sl, bool smax, cudaStream_t stream) {
  const dim3 grid((lp + BQ - 1) / BQ, h, b);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp32 = static_cast<float*>(lse);
  if (lse != nullptr)
    flash_fwd_kernel<DH, true, false><<<grid, NTHREADS, 0, stream>>>(
        qp, kp, vp, op, lp32, lp, h, l_real, scale, q_sb, q_sl, k_sb, k_sl,
        v_sb, v_sl);
  else if (smax)
    flash_fwd_kernel<DH, false, true><<<grid, NTHREADS, 0, stream>>>(
        qp, kp, vp, op, lp32, lp, h, l_real, scale, q_sb, q_sl, k_sb, k_sl,
        v_sb, v_sl);
  else
    flash_fwd_kernel<DH, false, false><<<grid, NTHREADS, 0, stream>>>(
        qp, kp, vp, op, lp32, lp, h, l_real, scale, q_sb, q_sl, k_sb, k_sl,
        v_sb, v_sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// Strides are in elements; the last dimension must be contiguous and every
// row start 16-byte aligned (checked by the Python wrapper).  `lse` is null
// (no stats) or a contiguous [b, lp, h] f32 buffer.  `smax` != 0 selects
// the scalar-max recurrence, which exports no stats.  dh in {16, 32, 64}.
extern "C" int odgs_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int lp,
    int h, int dh, int l_real, float scale, long long q_sb, long long q_sl,
    long long k_sb, long long k_sl, long long v_sb, long long v_sl,
    int smax, void* stream) {
  if (b == 0 || lp == 0 || h == 0) return 0;
  if (l_real < 1 || l_real > lp) return static_cast<int>(cudaErrorInvalidValue);
  if (smax && lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, o, lse, b, lp, h, l_real, scale, q_sb, q_sl,
                        k_sb, k_sl, v_sb, v_sl, smax != 0, s);
    case 32:
      return launch<32>(q, k, v, o, lse, b, lp, h, l_real, scale, q_sb, q_sl,
                        k_sb, k_sl, v_sb, v_sl, smax != 0, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, lp, h, l_real, scale, q_sb, q_sl,
                        k_sb, k_sl, v_sb, v_sl, smax != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
