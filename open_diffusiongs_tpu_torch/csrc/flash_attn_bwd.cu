// Exact multi-head attention backward on the packed DiT layout.
//
// Replaces the TPU Pallas kernels open_diffusiongs_tpu/ops/attention.py::
// flash_mha_packed_bwd (:435; bodies _bwd_dq_kernel :338 and
// _bwd_dkv_kernel :367).  Same algebra, in the exp2 domain of the forward
// (flash_attn_fwd.cu):
//   q~ = bf16(q * dh^-1/2 * log2 e)          (the forward's rounded q)
//   P  = exp2(q~ . k - lse)                  (lse from the stats forward)
//   dP = dO . v,  dS = P * (dP - delta)      (delta = rowsum(dO * O), given)
//   dq = (dh^-1/2) * dS . K,  dk = ln2 * dS^T . q~,  dv = P^T . dO
// f32 accumulation; P and dS are rounded to bf16 as the tensor cores' A
// operand (the TPU kernels cast them to the input dtype the same way).
// Keys >= l_real are excluded (zeroed K/V rows, P forced to 0); q rows
// >= l_real contribute nothing (zeroed q~/dO rows, P and dS forced to 0);
// every output row >= l_real is written as exactly 0.
//
// Design: the TPU's two-kernel split, which keeps the backward
// deterministic without atomics:
//   * dQ kernel: one 128-thread block per (64-row q tile, head, batch); the
//     q~ and dO tiles stay in registers (4 warps x 16 rows), 64-key K/V
//     tiles stream through shared memory (K both row-major, for q~.K^T,
//     and transposed, for dS.K);
//   * dK/dV kernel: one block per (64-key tile, head, batch); the K and V
//     tiles stay in registers, 64-row q~/dO tiles (row-major and
//     transposed) plus their lse/delta stream through shared memory.  It
//     works in the transposed orientation S^T = K.q~^T (rows = keys), so
//     the accumulators of P^T and dS^T are directly the A fragments of
//     P^T.dO and dS^T.q~.
// All products are mma.sync m16n8k16 (bf16 in, f32 accumulate); the
// accumulator of two adjacent n8 tiles is the A fragment of the next mma,
// so P and dS never leave registers.
//
// Inputs q/k/v may be column slices of one fused qkv projection, and the
// outputs dq/dk/dv column slices of one fused [b, Lp, 3*h*dh] gradient:
// each is addressed by its own batch and row strides.
//
// What bounds it: at the 256^2 flagship shape (L = 4098, h = 16, dh = 64)
// the pair runs 7 products of 2*L^2*dh per head (S and dP in both
// kernels, then dQ, dK, dV), ~241 GFLOP on ~50 MB of operands per batch
// element: bound by tensor-core throughput.  Like
// the forward, this first version has no cp.async/TMA pipelining, uses
// mma.sync instead of wgmma, and transposes tiles through bank-conflicted
// shared-memory stores; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile (4 warps x 16)
constexpr int BK = 64;          // keys per tile (4 warps x 16)
constexpr int NTHREADS = 128;
constexpr float LN2 = 0.6931471805599453f;

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

// One 16-byte chunk (8 values) of row `row` of a [rows, DH] head slice;
// zero when row >= valid.  `scale` != 0 pre-scales and re-rounds (q~).
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* base,
                                            long long row_stride, int row,
                                            int valid, int c8, float scale) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (row < valid) {
    raw = *reinterpret_cast<const uint4*>(base + (long long)row * row_stride + c8);
    if (scale != 0.f) {
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p2[i]);
        p2[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
  }
  return raw;
}

// Store one chunk row-major ([r][c8..c8+7], row pitch LD) and, optionally,
// transposed ([c8+i][r], row pitch LDT).
template <int LD, int LDT>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* rowmajor,
                                            __nv_bfloat16* transposed, int r,
                                            int c8, uint4 raw) {
  if (rowmajor != nullptr)
    *reinterpret_cast<uint4*>(&rowmajor[r * LD + c8]) = raw;
  if (transposed != nullptr) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) transposed[(c8 + i) * LDT + r] = e[i];
  }
}

// A fragments (16 rows x DH) of this warp's rows from a row-major tile.
template <int DH, int LD>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* tile,
                                             int warp, int g, int t4,
                                             uint32_t (&f)[DH / 16][4]) {
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t4;
    f[kk][0] = ld32(&tile[r0 * LD + c]);
    f[kk][1] = ld32(&tile[(r0 + 8) * LD + c]);
    f[kk][2] = ld32(&tile[r0 * LD + c + 8]);
    f[kk][3] = ld32(&tile[(r0 + 8) * LD + c + 8]);
  }
}

// acc[n-tile][4] = A(this warp's 16 rows x DH) . Bt^T where Bt is a
// row-major [64, DH] tile (rows = the 64 output columns).
template <int DH, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[DH / 16][4],
                                        const __nv_bfloat16* bt, int g,
                                        int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* p = &bt[(nt * 8 + g) * LD + kk * 16 + 2 * t4];
      mma16816(acc[nt], a[kk], ld32(p), ld32(p + 8));
    }
}

// out[d-tile][4] += X(16 rows x 64, as accumulator fragments) . Y where
// Yt is Y^T stored row-major [DH, 64] (pitch LDT): X's fragments of two
// adjacent n8 tiles form the A fragment of one k16 step.
template <int DH, int LDT>
__device__ __forceinline__ void mma_xy(float (&out)[DH / 8][4],
                                       const float (&x)[8][4],
                                       const __nv_bfloat16* yt, int g,
                                       int t4) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * kj][0], x[2 * kj][1]),
                           pack_bf16x2(x[2 * kj][2], x[2 * kj][3]),
                           pack_bf16x2(x[2 * kj + 1][0], x[2 * kj + 1][1]),
                           pack_bf16x2(x[2 * kj + 1][2], x[2 * kj + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const __nv_bfloat16* p = &yt[(dt * 8 + g) * LDT + kj * 16 + 2 * t4];
      mma16816(out[dt], a, ld32(p), ld32(p + 8));
    }
  }
}

// Write this warp's 16 output rows (rows >= l_real as 0, rows >= lp
// skipped), scaled.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sl,
                                           int row0, int lp, int l_real,
                                           const float (&acc)[DH / 8][4],
                                           float scale, int t4) {
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r >= lp) continue;
      const bool real = r < l_real;
      *reinterpret_cast<uint32_t*>(out + (long long)r * sl + c) =
          pack_bf16x2(real ? acc[dt][2 * half] * scale : 0.f,
                      real ? acc[dt][2 * half + 1] * scale : 0.f);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;      // [b, lp, h] f32, contiguous
  __nv_bfloat16 *dq, *dk, *dv;
  int lp, h, l_real;
  float scale;                   // dh^-1/2 * log2 e (the forward's)
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl;
  long long dq_sb, dq_sl, dk_sb, dk_sl, dv_sb, dv_sl;
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Args a) {
  constexpr int LD = DH + 8;       // padded row-major row
  constexpr int LDT = BK + 8;      // padded transposed row
  constexpr int CPR = DH / 8;      // 16-byte chunks per head row
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LD];   // q~, then dO
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 kt[DH * LDT];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const int col0 = head * DH;
  const __nv_bfloat16* qb = a.q + bi * a.q_sb + col0 + q0 * a.q_sl;
  const __nv_bfloat16* db = a.dout + bi * a.do_sb + col0 + q0 * a.do_sl;
  const __nv_bfloat16* kb = a.k + bi * a.k_sb + col0;
  const __nv_bfloat16* vb = a.v + bi * a.v_sb + col0;
  const int rows_here = min(a.l_real - q0, BQ);   // real rows in this tile

  // q~ (rows >= l_real zero) -> registers, then dO -> registers.
  uint32_t qf[DH / 16][4], df[DH / 16][4];
  for (int c = tid; c < BQ * CPR; c += NTHREADS) {
    const int r = c / CPR, c8 = (c % CPR) * 8;
    store_chunk<LD, LDT>(qs, nullptr, r, c8,
                         load_chunk(qb, a.q_sl, r, rows_here, c8, a.scale));
  }
  __syncthreads();
  load_a_frags<DH, LD>(qs, warp, g, t4, qf);
  __syncthreads();
  for (int c = tid; c < BQ * CPR; c += NTHREADS) {
    const int r = c / CPR, c8 = (c % CPR) * 8;
    store_chunk<LD, LDT>(qs, nullptr, r, c8,
                         load_chunk(db, a.do_sl, r, rows_here, c8, 0.f));
  }
  __syncthreads();
  load_a_frags<DH, LD>(qs, warp, g, t4, df);

  // This thread's two rows (g and g + 8 of the warp's 16): lse and delta.
  const int r0 = q0 + warp * 16 + g;
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const long long o = ((long long)bi * a.lp + r) * a.h + head;
    lse_r[half] = r < a.l_real ? a.lse[o] : 0.f;
    dlt_r[half] = r < a.l_real ? a.delta[o] : 0.f;
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j] = 0.f;

  const int n_kt = rows_here > 0 ? (a.l_real + BK - 1) / BK : 0;
  for (int kt_i = 0; kt_i < n_kt; ++kt_i) {
    const int k0 = kt_i * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * CPR; c += NTHREADS) {
      const int r = c / CPR, c8 = (c % CPR) * 8;
      const int valid = a.l_real - k0;
      store_chunk<LD, LDT>(ks, kt, r, c8,
                           load_chunk(kb + k0 * a.k_sl, a.k_sl, r, valid, c8, 0.f));
      store_chunk<LD, LDT>(vs, nullptr, r, c8,
                           load_chunk(vb + k0 * a.v_sl, a.v_sl, r, valid, c8, 0.f));
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<DH, LD>(s, qf, ks, g, t4);    // S  = q~ . K^T
    mma_abt<DH, LD>(dp, df, vs, g, t4);   // dP = dO . V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + 2 * t4 + (j & 1);
        const int half = j >> 1;
        const float p = key < a.l_real ? exp2f(s[nt][j] - lse_r[half]) : 0.f;
        s[nt][j] = p * (dp[nt][j] - dlt_r[half]);            // dS
      }
    mma_xy<DH, LDT>(acc, s, kt, g, t4);   // dQ += dS . K
  }
  store_rows<DH>(a.dq + bi * a.dq_sb + col0, a.dq_sl, r0, a.lp, a.l_real, acc,
                 a.scale * LN2, t4);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Args a) {
  constexpr int LD = DH + 8;
  constexpr int LDT = BQ + 8;
  constexpr int CPR = DH / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LD];    // q~ row-major
  __shared__ __align__(16) __nv_bfloat16 qt[DH * LDT];   // q~ transposed
  __shared__ __align__(16) __nv_bfloat16 ds[BQ * LD];    // dO row-major
  __shared__ __align__(16) __nv_bfloat16 dt_[DH * LDT];  // dO transposed
  __shared__ float lse_s[BQ], dlt_s[BQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BK, head = blockIdx.y, bi = blockIdx.z;
  const int col0 = head * DH;
  const __nv_bfloat16* qb = a.q + bi * a.q_sb + col0;
  const __nv_bfloat16* db = a.dout + bi * a.do_sb + col0;
  const int keys_here = min(a.l_real - k0, BK);

  // K and V tiles of this block's keys (rows >= l_real zero) -> registers,
  // staged through the q~ / dO buffers.
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  for (int c = tid; c < BK * CPR; c += NTHREADS) {
    const int r = c / CPR, c8 = (c % CPR) * 8;
    store_chunk<LD, LDT>(qs, nullptr, r, c8,
                         load_chunk(a.k + bi * a.k_sb + col0 + k0 * a.k_sl,
                                    a.k_sl, r, keys_here, c8, 0.f));
    store_chunk<LD, LDT>(ds, nullptr, r, c8,
                         load_chunk(a.v + bi * a.v_sb + col0 + k0 * a.v_sl,
                                    a.v_sl, r, keys_here, c8, 0.f));
  }
  __syncthreads();
  load_a_frags<DH, LD>(qs, warp, g, t4, kf);
  load_a_frags<DH, LD>(ds, warp, g, t4, vf);

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[d][j] = dv[d][j] = 0.f;

  const int n_qt = keys_here > 0 ? (a.l_real + BQ - 1) / BQ : 0;
  for (int qt_i = 0; qt_i < n_qt; ++qt_i) {
    const int q0 = qt_i * BQ;
    const int valid = a.l_real - q0;
    __syncthreads();   // every warp is done with the previous q~/dO tile
    for (int c = tid; c < BQ * CPR; c += NTHREADS) {
      const int r = c / CPR, c8 = (c % CPR) * 8;
      store_chunk<LD, LDT>(qs, qt, r, c8,
                           load_chunk(qb + q0 * a.q_sl, a.q_sl, r, valid, c8,
                                      a.scale));
      store_chunk<LD, LDT>(ds, dt_, r, c8,
                           load_chunk(db + q0 * a.do_sl, a.do_sl, r, valid, c8,
                                      0.f));
    }
    if (tid < BQ) {
      const int r = q0 + tid;
      const long long o = ((long long)bi * a.lp + r) * a.h + head;
      lse_s[tid] = r < a.l_real ? a.lse[o] : 0.f;
      dlt_s[tid] = r < a.l_real ? a.delta[o] : 0.f;
    }
    __syncthreads();

    float p[8][4], dsc[8][4];
    mma_abt<DH, LD>(p, kf, qs, g, t4);     // S^T  = K . q~^T
    mma_abt<DH, LD>(dsc, vf, ds, g, t4);   // dP^T = V . dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + 2 * t4 + (j & 1);    // q row in the tile
        const bool real = q0 + col < a.l_real;
        const float pv = real ? exp2f(p[nt][j] - lse_s[col]) : 0.f;
        p[nt][j] = pv;
        dsc[nt][j] = real ? pv * (dsc[nt][j] - dlt_s[col]) : 0.f;
      }
    mma_xy<DH, LDT>(dv, p, dt_, g, t4);    // dV += P^T . dO
    mma_xy<DH, LDT>(dk, dsc, qt, g, t4);   // dK += dS^T . q~
  }
  const int row0 = k0 + warp * 16 + g;
  store_rows<DH>(a.dk + bi * a.dk_sb + col0, a.dk_sl, row0, a.lp, a.l_real,
                 dk, LN2, t4);
  store_rows<DH>(a.dv + bi * a.dv_sb + col0, a.dv_sl, row0, a.lp, a.l_real,
                 dv, 1.f, t4);
}

template <int DH>
int launch(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid_q((a.lp + BQ - 1) / BQ, a.h, b);
  flash_bwd_dq_kernel<DH><<<grid_q, NTHREADS, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k((a.lp + BK - 1) / BK, a.h, b);
  flash_bwd_dkv_kernel<DH><<<grid_k, NTHREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream`; returns the first failing launch's
// cudaError_t (0 = success).  q/k/v/dout/dq/dk/dv: bf16 [b, lp, h*dh]
// views addressed by (batch, row) strides in elements, last dimension
// contiguous, rows 16-byte aligned (checked by the Python wrapper); lse and
// delta: contiguous [b, lp, h] f32.  dout must be zero on rows >= l_real.
// dh in {16, 32, 64}.
extern "C" int odgs_flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int lp, int h, int dh, int l_real, float scale, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, long long do_sb, long long do_sl, long long dq_sb,
    long long dq_sl, long long dk_sb, long long dk_sl, long long dv_sb,
    long long dv_sl, void* stream) {
  if (b == 0 || lp == 0 || h == 0) return 0;
  if (l_real < 1 || l_real > lp) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.lp = lp;
  a.h = h;
  a.l_real = l_real;
  a.scale = scale;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl; a.do_sb = do_sb; a.do_sl = do_sl;
  a.dq_sb = dq_sb; a.dq_sl = dq_sl; a.dk_sb = dk_sb; a.dk_sl = dk_sl;
  a.dv_sb = dv_sb; a.dv_sl = dv_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(a, b, s);
    case 32: return launch<32>(a, b, s);
    case 64: return launch<64>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
