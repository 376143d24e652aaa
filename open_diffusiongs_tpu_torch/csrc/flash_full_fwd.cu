// Exact non-causal multi-head attention forward on the [b, l, h, d] layout.
//
// Replaces two TPU Pallas kernels:
//   * open_diffusiongs_tpu/ops/attention.py::flash_full_mha (:638-665;
//     _mha_padded :77-103, body _fwd_kernel :44-74), the DiT's general
//     attention route (qk_norm blocks, head widths that fail the packed
//     lane test, subset attention);
//   * tools/bench_attn2.py::mha_full (:89-126, body _fwd_kernel :43-86), the
//     bench tool's variant sweep, as the `PV_F32` / `SCORE_BF16` flags.
// Same math:
//   q/k/v bf16, element (b, row, head, c) at b*sb + row*sl + head*sh + c
//   (own strides per tensor, last dimension contiguous), any head width
//   d <= 64, any number of heads and rows;
//   q~ = bf16(q * scale): `scale` is d^-1/2 * log2(e) already rounded to
//   bf16 by the wrapper, as #5 forms both in q's dtype (:652-654); the
//   bench variant passes a pre-scaled q and scale 1 (an exact no-op);
//   online softmax in base 2 with f32 running max and sum; keys >= l_real
//   never contribute (score -inf, zeroed K/V rows); the denominator is
//   clamped at 1e-30 (:73); output bf16 through its own strides.
// The TPU kernels find the row sum through a validity ones-column of V in
// the P·V matmul, so numerator and denominator see the same P; here the
// row sum is taken in registers over the same P operand the P·V mma gets.
//
// P·V operand (PV_F32): the TPU keeps P in f32 (#5 always, :61-65; #6 with
// pv_f32).  The closest tensor-core form is tf32: mma.sync m16n8k8 with P
// rounded to tf32 (cvt.rna, 10-bit mantissa) and V widened from bf16 (exact
// in tf32).  So P carries a relative rounding of <= 2^-11 against the TPU's
// f32 P, 16x finer than the bf16 P of the packed kernel (flash_attn_fwd.cu)
// and of #6 without pv_f32, which is the bf16 m16n8k16 path here.
// SCORE_BF16 (#6's score_bf16, bench_attn2 :55-63, :79-80): the scores,
// s - m, the exp2 and alpha are rounded to bf16 as the TPU does with a
// bf16 score dtype.  The TPU's running max also sees the pad keys of #6
// (their V and validity are zero, so only the max moves); here keys >=
// l_real are excluded from it, which is the same function in exact
// arithmetic.  The TPU's `sub` switch (tile / bcast) is a lane-broadcast
// detail with identical results and has no counterpart.
//
// Design: the FlashAttention-2 shape of flash_attn_fwd.cu.  One 128-thread
// block per (64-row q tile, head, batch), 4 warps x 16 rows; Q fragments in
// registers; 64-key K and V tiles staged through shared memory (V
// transposed).  The head's d columns are loaded into a tile DH wide (DH in
// {16, 32, 48, 64}, the smallest >= d) and the rest zero-filled: zero
// columns add nothing to q·kᵀ and are never written.  Rows whose d*2 bytes
// or strides are not 16-byte multiples (e.g. d = 20) take an element-wise
// load path (VEC = false).  For the tf32 P·V the keys of each 8-key k-step
// are permuted: k index t4 is key 2*t4 and t4 + 4 is key 2*t4 + 1, which is
// where the Q·Kᵀ accumulator already holds them, so P stays in registers
// and V's B fragment is one 32-bit load of two adjacent bf16 keys.
//
// What bounds it: at the DiT's L = 4098, h = 16, d = 64 one call is
// 4·L²·d·h ≈ 68.8 GFLOP on ~25 MB of q/k/v, far above the H100's ridge:
// tensor-core issue rate, and the tf32 P·V runs at half the bf16 rate.  Like
// the packed kernel this first version has no cp.async/TMA pipelining and
// uses mma.sync instead of wgmma; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int lq, h, d, l_real;          // q rows, heads, head width, keys
  float scale;                   // q pre-scale (bf16-representable)
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
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

// D = A(16x8, row) * B(8x8, col) + D, tf32 inputs, f32 accumulators.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Columns c8 .. c8+7 of one head row, zero past d (and for invalid rows).
// VEC: d, the strides and the base are 16-byte multiples, one 16-byte load.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, bool valid,
                                       int c8, int d) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (!valid) return raw;
  if (VEC) {
    if (c8 < d) raw = *reinterpret_cast<const uint4*>(row + c8);
  } else {
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c8 + i < d) e[i] = row[c8 + i];
  }
  return raw;
}

template <int DH, bool PV_F32, bool SCORE_BF16, bool VEC>
__global__ void __launch_bounds__(NTHREADS) flash_full_kernel(Args a) {
  constexpr int LDQ = DH + 8;      // padded Qs/Ks row: conflict-free frags
  constexpr int LDV = BK + 8;      // padded row of the transposed V tile
  constexpr int CPR = DH / 8;      // 8-column chunks per head row
  constexpr int KSTEPS = DH / 16;  // mma k-steps of Q·Kᵀ
  constexpr int DTILES = DH / 8;   // mma n-tiles of the output row
  static_assert(DH % 16 == 0 && DH <= 64, "DH in {16, 32, 48, 64}");
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LDQ];
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDQ];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * LDV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma group / thread-in-group
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const __nv_bfloat16* qb = a.q + bi * a.q_sb + head * a.q_sh;
  const __nv_bfloat16* kb = a.k + bi * a.k_sb + head * a.k_sh;
  const __nv_bfloat16* vb = a.v + bi * a.v_sb + head * a.v_sh;

  // Q tile: q~ = bf16(q * scale); rows past lq and columns past d are zero.
  for (int c = tid; c < BQ * CPR; c += NTHREADS) {
    const int r = c / CPR, c8 = (c % CPR) * 8;
    uint4 raw = load8<VEC>(qb + (long long)(q0 + r) * a.q_sl, q0 + r < a.lq,
                           c8, a.d);
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p2[i]);
      p2[i] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
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
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j] = 0.f;

  const int n_kt = (a.l_real + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * CPR; c += NTHREADS) {
      const int r = c / CPR, c8 = (c % CPR) * 8;
      const bool real = k0 + r < a.l_real;
      const uint4 kr = load8<VEC>(kb + (long long)(k0 + r) * a.k_sl, real,
                                  c8, a.d);
      const uint4 vr = load8<VEC>(vb + (long long)(k0 + r) * a.v_sl, real,
                                  c8, a.d);
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
    if (SCORE_BF16) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = round_bf16(s[nt][j]);
    }
    if (k0 + BK > a.l_real) {   // ragged last tile: keys >= l_real drop out
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + nt * 8 + 2 * t4 + (j & 1) >= a.l_real) s[nt][j] = -INFINITY;
    }

    // Online softmax in base 2.  Every processed tile holds >= 1 real key,
    // so the new max is finite and exp2f(-inf - m) = 0 on the first tile.
    float mt0 = m_run[0], mt1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mt0 = fmaxf(mt0, fmaxf(s[nt][0], s[nt][1]));
      mt1 = fmaxf(mt1, fmaxf(s[nt][2], s[nt][3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
    float a0, a1;
    if (SCORE_BF16) {
      a0 = round_bf16(exp2f(round_bf16(m_run[0] - mt0)));
      a1 = round_bf16(exp2f(round_bf16(m_run[1] - mt1)));
    } else {
      a0 = exp2f(m_run[0] - mt0);
      a1 = exp2f(m_run[1] - mt1);
    }
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
    // P, rounded to the P·V operand's type; the row sum takes the same P.
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float m = j < 2 ? mt0 : mt1;
        float p = SCORE_BF16 ? round_bf16(exp2f(round_bf16(s[nt][j] - m)))
                             : exp2f(s[nt][j] - m);
        p = PV_F32 ? round_tf32(p) : round_bf16(p);
        s[nt][j] = p;
        l_run[j >> 1] += p;
      }

    if (PV_F32) {
      // O += P·V in tf32, one k-step per 8 keys (permuted as in the header).
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const uint32_t pa[4] = {__float_as_uint(s[nt][0]),
                                __float_as_uint(s[nt][2]),
                                __float_as_uint(s[nt][1]),
                                __float_as_uint(s[nt][3])};
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          const uint32_t w = ld32(&vt[(dt * 8 + g) * LDV + nt * 8 + 2 * t4]);
          mma1688_tf32(acc[dt], pa, w << 16, w & 0xffff0000u);
        }
      }
    } else {
      // O += P·V in bf16: the score fragments of n-tiles 2j, 2j+1 are the
      // A fragment of k-step j.
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
  }

  // Row sums live spread over the 4 threads of a group.
  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  const int r0 = q0 + warp * 16 + g;
  __nv_bfloat16* ob = a.o + bi * a.o_sb + head * a.o_sh;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (c >= a.d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= a.lq) continue;
      __nv_bfloat16* dst = ob + (long long)r * a.o_sl + c;
      const float x0 = acc[dt][2 * half] * inv[half];
      const float x1 = acc[dt][2 * half + 1] * inv[half];
      if (VEC) {               // d even: both columns exist, 4-byte aligned
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (c + 1 < a.d) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DH, bool PV_F32, bool SCORE_BF16>
int launch(const Args& a, int b, bool vec, cudaStream_t stream) {
  const dim3 grid((a.lq + BQ - 1) / BQ, a.h, b);
  if (vec)
    flash_full_kernel<DH, PV_F32, SCORE_BF16, true>
        <<<grid, NTHREADS, 0, stream>>>(a);
  else
    flash_full_kernel<DH, PV_F32, SCORE_BF16, false>
        <<<grid, NTHREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, long long sb, long long sl, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         sl % 8 == 0 && sh % 8 == 0;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// q/k/v bf16 read through (batch, row, head) strides in elements; o bf16
// written through its own strides; the last dimension of every tensor is
// contiguous.  lq q rows; the first l_real rows of k/v are the keys (k/v
// may hold more rows, or fewer than lq: their own count).  pv_f32 = 1,
// score_bf16 = 0 is flash_full_mha, for any d in 1..64; the other three
// flag pairs are the bench variants and take d = 64 with 16-byte aligned
// rows only.
extern "C" int odgs_flash_full_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int lq,
    int h, int d, int l_real, float scale, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, int pv_f32, int score_bf16,
    void* stream) {
  if (b == 0 || lq == 0 || h == 0) return 0;
  if (l_real < 1 || d < 1 || d > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lq = lq;
  a.h = h;
  a.d = d;
  a.l_real = l_real;
  a.scale = scale;
  a.q_sb = q_sb; a.q_sl = q_sl; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sl = k_sl; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sl = v_sl; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_sl = o_sl; a.o_sh = o_sh;
  const bool vec = d % 8 == 0 && aligned16(q, q_sb, q_sl, q_sh) &&
                   aligned16(k, k_sb, k_sl, k_sh) &&
                   aligned16(v, v_sb, v_sl, v_sh) &&
                   aligned16(o, o_sb, o_sl, o_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pv_f32 && !score_bf16) {
    if (d <= 16) return launch<16, true, false>(a, b, vec, s);
    if (d <= 32) return launch<32, true, false>(a, b, vec, s);
    if (d <= 48) return launch<48, true, false>(a, b, vec, s);
    return launch<64, true, false>(a, b, vec, s);
  }
  if (d != 64 || !vec) return static_cast<int>(cudaErrorInvalidValue);
  if (pv_f32) return launch<64, true, true>(a, b, true, s);
  if (score_bf16) return launch<64, false, true>(a, b, true, s);
  return launch<64, false, false>(a, b, true, s);
}
