// Exact non-causal multi-head attention forward on the packed DiT layout.
//
// Replaces the TPU Pallas kernel open_diffusiongs_tpu/ops/attention.py::
// flash_mha_packed (body _fwd_kernel_packed, :221-290).  Same math:
//   q/k/v [b, Lp, h*dh] bf16, head h in columns h*dh .. h*dh+dh-1;
//   q is pre-scaled by dh^-1/2 * log2(e) in f32 and rounded back to bf16;
//   the online softmax runs in base 2 (exp2f) with f32 running max / sum;
//   keys >= lk_real are excluded (TMA reads their K and V rows as 0, and
//   their scores are set to -inf, so pad-row garbage cannot leak);
//   P is rounded to bf16 for P.V, the row sum takes the unrounded f32 P;
//   output in bf16 for every row < Lp (rows >= lq_real are the caller's
//   pad rows: computed like the others, and thrown away).
// With a non-null `lse` (the training forward, body _fwd_kernel_packed_stats
// :212) it also writes the base-2 log-sum-exp m + log2(l) of every row
// < lq_real into lse [b, Lp, h] f32 (rows >= lq_real get 0): the one
// forward fact the backward (flash_attn_bwd.cu) rebuilds P from.
// With `o_f32` o is written in f32 instead, the same values before their
// rounding: a ring step's output (parallel/ring.py), merged with the other
// steps' before its one rounding to bf16, as one launch over every key
// rounds it once.
// The query and key extents are separate because a ring step of sequence
// parallelism (parallel/ring.py) attends a full query shard to the tail
// shard's keys, or the tail's queries to a full shard's keys; one extent
// l_real for both is lq_real = lk_real = l_real, as on the TPU (which writes
// the lse of every row and masks keys only).
// With `SMAX` (body _fwd_kernel_packed_smax :146-210, flash_mha_packed(
// scalar_max=True)) the running max is one scalar per (64-row q tile, head)
// instead of one per row: each key tile's max is reduced over the
// warpgroup's 64 rows (shuffles within each row quad and across the warp,
// then shared memory and a 128-thread named barrier over its 4 warps).  As
// on the TPU, the zeroed pad keys (score 0) count toward that max when
// Lp > lk_real, and so do the tile's pad rows (< Lp); rows past Lp are not
// part of the tile.  A row whose scores all sit > ~126 below the tile max
// underflows to 0 (denominator clamped at 1e-30, as :207).
// The TPU kernel's V "ones column" (an MXU trick for the row sum) is not
// carried over: the row sum is accumulated in registers.
//
// What bounds it: at the 256^2 flagship shape (Lp = l_real = 4098, h = 16,
// dh = 64) one call is 4·L²·dh·h ≈ 68.8 GFLOP of tensor-core work on
// ~25 MB of q/k/v: 0.070 ms at the H100's 989 TFLOP/s bf16, far above the
// memory bound.  The softmax's L²·h ≈ 2.7e8 exp2 per batch element run on
// the SFUs at ≈ 3.9e12/s, ≈ 0.07 ms too: at dh = 64 the exponentials cost
// as much as the products, so the design overlaps them.
//
// Design (FlashAttention-3's shape, kept simple): one block per (128-row q
// tile, head, batch) of three warpgroups.
//   * Producer (warpgroup 2, one thread; setmaxnreg 40): TMA loads of the
//     q tile once, then of 128-key K and V tiles into a ring of NSTAGE
//     stages in dynamic shared memory, each stage with a full and an empty
//     mbarrier.  The tensor maps are 3-D {h*dh, rows, b} with the caller's
//     row and batch strides, so q/k/v may be column slices of one fused qkv
//     projection; they are encoded on the host at every launch.  K/V maps
//     end at row lk_real, so TMA zero-fills the keys >= lk_real.  Each row of
//     a tile is one swizzle span (128/64/32 B at dh 64/32/16).
//   * Consumers (warpgroups 0 and 1, 64 q rows each; setmaxnreg 232): the
//     q rows come from shared memory into registers, pre-scaled and rounded
//     there, and are the A operand of S = q~.K^T (wgmma m64n128k16, A from
//     registers, K as a K-major B).  P is converted in registers from the
//     f32 accumulator to bf16 A fragments of O += P.V (wgmma m64n{dh}k16),
//     with V read MN-major through the transpose bit: no transposed copy.
//   * Overlap, within each warpgroup: at key tile j the warpgroup issues
//     S_j and then P_{j-1}.V_{j-1} as two commit groups, waits for S_j
//     only, and runs tile j's masking, max and exp2 while P_{j-1}.V_{j-1}
//     is still on the tensor cores; then it waits for that product,
//     releases stage j-1 to the producer and rescales O.  The two
//     warpgroups run independently, so one's softmax also overlaps the
//     other's products.
//   * Epilogue: O goes out as bf16 (or f32) from registers (rows >= Lp
//     never written), the lse per row < lq_real.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace odgs;

constexpr int WG = 128;          // threads per warpgroup
constexpr int ROWS = 64;         // q rows per consumer warpgroup
constexpr int BQ = 2 * ROWS;     // q rows per block
constexpr int BK = 128;          // keys per stage
constexpr int NSTAGE = 3;
constexpr int NTHREADS = 3 * WG; // consumers 0 and 1, producer 2
constexpr unsigned FULL = 0xffffffffu;

template <int DH>
struct FwdSmem {
  alignas(1024) __nv_bfloat16 q[BQ * DH];
  alignas(1024) __nv_bfloat16 k[NSTAGE][BK * DH];
  alignas(1024) __nv_bfloat16 v[NSTAGE][BK * DH];
  uint64_t full[NSTAGE], empty[NSTAGE], qfull;
  float red[2][2][4];   // SMAX: [warpgroup][tile parity][warp] maxima
};

struct FwdParams {
  CUtensorMap tq, tk, tv;
  void* o;       // bf16, or f32 with o_f32
  float* lse;
  int lp, h, o_f32;
  int lk_real;   // keys < lk_real take part
  int lq_real;   // rows < lq_real get their lse
  float scale;
};

template <int DH, bool STATS, bool SMAX>
__device__ __forceinline__ void fwd_consumer(const FwdParams& p,
                                             FwdSmem<DH>& s, int wg, int q0,
                                             int head, int bi, int n_kt) {
  constexpr int KSTEPS = DH / 16;   // k16 steps of q~.K^T
  constexpr int PSTEPS = BK / 16;   // k16 steps of P.V
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rl = wg * ROWS + warp * 16 + g;   // rows rl and rl + 8 of the tile
  const int r0 = q0 + rl;

  // q~ A fragments: rows rl (+8), columns 16 kk + 2 t4 (+8), pre-scaled.
  mbar_wait(&s.qfull, 0);
  uint32_t qf[KSTEPS][4];
  load_a_frags<DH>(s.q, rl, t4, qf);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]));
      qf[kk][i] = pack_bf16x2(f.x * p.scale, f.y * p.scale);
    }

  float sacc[BK / 2], oacc[DH / 2];
  uint32_t pf[PSTEPS][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
  // SMAX: both entries hold the tile's one max, which starts at the pad
  // keys' score 0 when there are pad keys (Lp > lk_real).
  const float m0 = (SMAX && p.lp > p.lk_real) ? 0.f : -INFINITY;
  float m_run[2] = {m0, m0}, l_run[2] = {0.f, 0.f};

  auto issue_s = [&](int st) {
    const uint64_t kd = make_desc<DH>(s.k[st]);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<BK>::template rs<0>(sacc, qf[kk], desc_add(kd, kk * 32), kk > 0);
  };
  auto issue_pv = [&](int st) {
    const uint64_t vd = make_desc<DH>(s.v[st]);
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj)
      Wgmma<DH>::template rs<1>(oacc, pf[kj], desc_add(vd, kj * 16 * DH * 2),
                                1);
  };
  // Masks, the new max, sacc <- 2^(s - m) and this thread's part of the
  // row sums; alpha rescales what was accumulated before tile j.
  auto softmax = [&](int j, float (&alpha)[2], float (&ls)[2]) {
    const int k0 = j * BK;
    if (k0 + BK > p.lk_real) {   // ragged last tile: keys >= lk_real drop out
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= p.lk_real) sacc[i] = -INFINITY;
    }
    if (SMAX && q0 + BQ > p.lp) {   // rows past Lp are not part of the tile
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (r0 + 8 * ((i >> 1) & 1) >= p.lp) sacc[i] = -INFINITY;
    }
    float mt0 = m_run[0], mt1 = m_run[1];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mt0 = fmaxf(mt0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      mt1 = fmaxf(mt1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
    if (SMAX) {   // one max over the warpgroup's 64 rows
      mt0 = fmaxf(mt0, mt1);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, off));
      if (lane == 0) s.red[wg][j & 1][warp] = mt0;
      bar_sync(1 + wg, WG);         // red[wg][j & 1] is rewritten two tiles
                                    // later, after the next tile's barrier
#pragma unroll
      for (int w = 0; w < 4; ++w) mt0 = fmaxf(mt0, s.red[wg][j & 1][w]);
      mt1 = mt0;
    } else {
      mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
      mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
      mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
    }
    // Every processed tile holds >= 1 real key (and, SMAX, >= 1 row < Lp),
    // so the new max is finite and exp2f(-inf - m) = 0 on the first tile.
    alpha[0] = exp2f(m_run[0] - mt0);
    alpha[1] = exp2f(m_run[1] - mt1);
    m_run[0] = mt0;
    m_run[1] = mt1;
    ls[0] = ls[1] = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      sacc[4 * n] = exp2f(sacc[4 * n] - mt0);
      sacc[4 * n + 1] = exp2f(sacc[4 * n + 1] - mt0);
      sacc[4 * n + 2] = exp2f(sacc[4 * n + 2] - mt1);
      sacc[4 * n + 3] = exp2f(sacc[4 * n + 3] - mt1);
      ls[0] += sacc[4 * n] + sacc[4 * n + 1];
      ls[1] += sacc[4 * n + 2] + sacc[4 * n + 3];
    }
  };
  // The accumulator of n8 tiles 2 kj, 2 kj + 1 is the A fragment of k16
  // step kj; P is rounded to bf16 here.
  auto to_p = [&]() {
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kj][i] = pack_bf16x2(sacc[8 * kj + 2 * i], sacc[8 * kj + 2 * i + 1]);
  };

  float alpha[2], ls[2];
  mbar_wait(&s.full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
  softmax(0, alpha, ls);
  l_run[0] = ls[0];
  l_run[1] = ls[1];
  to_p();
  for (int j = 1; j < n_kt; ++j) {
    const int st = j % NSTAGE, prev = (j - 1) % NSTAGE;
    mbar_wait(&s.full[st], (j / NSTAGE) & 1);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
    wgmma_wait<1>();          // S_j is done; P_{j-1}.V_{j-1} may still run
    fence_regs(sacc);
    softmax(j, alpha, ls);
    wgmma_wait<0>();
    fence_regs(oacc);
    if (tid == 0) mbar_arrive(&s.empty[prev]);
    l_run[0] = l_run[0] * alpha[0] + ls[0];
    l_run[1] = l_run[1] * alpha[1] + ls[1];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      oacc[4 * n] *= alpha[0];
      oacc[4 * n + 1] *= alpha[0];
      oacc[4 * n + 2] *= alpha[1];
      oacc[4 * n + 3] *= alpha[1];
    }
    to_p();
  }
  wgmma_fence();
  issue_pv((n_kt - 1) % NSTAGE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oacc);

  // Row sums live spread over the 4 threads of a quad.
  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  // Clamped as on the TPU (:73, :207): only a SMAX row can underflow to 0.
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o_sl = (long long)p.h * DH;
  const long long o_off = (long long)bi * p.lp * o_sl + head * DH;
  if (p.o_f32) {
    float* ob = static_cast<float*>(p.o) + o_off;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (r0 < p.lp)
        *reinterpret_cast<float2*>(ob + r0 * o_sl + c) =
            make_float2(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
      if (r0 + 8 < p.lp)
        *reinterpret_cast<float2*>(ob + (r0 + 8) * o_sl + c) =
            make_float2(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
    }
  } else {
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + o_off;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (r0 < p.lp)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_sl + c) =
            pack_bf16x2(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
      if (r0 + 8 < p.lp)
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * o_sl + c) =
            pack_bf16x2(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
    }
  }
  if (STATS && t4 == 0) {   // m and l are shared by the 4 threads of a quad
    float* lb = p.lse + (long long)bi * p.lp * p.h + head;
    if (r0 < p.lp)
      lb[(long long)r0 * p.h] = r0 < p.lq_real ? m_run[0] + log2f(l0) : 0.f;
    if (r0 + 8 < p.lp)
      lb[(long long)(r0 + 8) * p.h] =
          r0 + 8 < p.lq_real ? m_run[1] + log2f(l1) : 0.f;
  }
}

template <int DH, bool STATS, bool SMAX>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  FwdSmem<DH>& s = smem_storage<FwdSmem<DH>>(smem_raw);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const int wg = threadIdx.x / WG;
  const int n_active = q0 + ROWS < p.lp ? 2 : 1;   // consumers with rows < Lp
  const int n_kt = (p.lk_real + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], n_active);
    }
    mbar_init(&s.qfull, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(&s.qfull, BQ * DH * 2);
      tma_load_3d(s.q, &p.tq, &s.qfull, head * DH, q0, bi);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % NSTAGE;
        mbar_wait(&s.empty[st], ((j / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * BK * DH * 2);
        tma_load_3d(s.k[st], &p.tk, &s.full[st], head * DH, j * BK, bi);
        tma_load_3d(s.v[st], &p.tv, &s.full[st], head * DH, j * BK, bi);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg < n_active)
      fwd_consumer<DH, STATS, SMAX>(p, s, wg, q0, head, bi, n_kt);
  }
}

template <int DH, bool STATS, bool SMAX>
int launch_kernel(const FwdParams& p, int b, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<DH, STATS, SMAX>;
  constexpr int smem = smem_bytes<FwdSmem<DH>>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.lp + BQ - 1) / BQ, p.h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int lp, int h, int lk_real, int lq_real, float scale,
           long long q_sb,
           long long q_sl, long long k_sb, long long k_sl, long long v_sb,
           long long v_sl, bool smax, bool o_f32, cudaStream_t stream) {
  FwdParams p;
  const int width = h * DH;
  if (!make_map_bf16<DH>(&p.tq, q, width, lp, b, q_sl, q_sb, BQ) ||
      !make_map_bf16<DH>(&p.tk, k, width, lk_real, b, k_sl, k_sb, BK) ||
      !make_map_bf16<DH>(&p.tv, v, width, lk_real, b, v_sl, v_sb, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = o;
  p.o_f32 = o_f32;
  p.lse = static_cast<float*>(lse);
  p.lp = lp;
  p.h = h;
  p.lk_real = lk_real;
  p.lq_real = lq_real;
  p.scale = scale;
  if (lse != nullptr) return launch_kernel<DH, true, false>(p, b, stream);
  if (smax) return launch_kernel<DH, false, true>(p, b, stream);
  return launch_kernel<DH, false, false>(p, b, stream);
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// Strides are in elements; the last dimension must be contiguous, the base
// 16-byte aligned and the row and batch strides multiples of 8 elements
// (TMA's 16-byte rule; checked by the Python wrapper).  `lse` is null (no
// stats) or a contiguous [b, lp, h] f32 buffer.  `smax` != 0 selects the
// scalar-max recurrence, which exports no stats.  Keys < lk_real take part;
// the lse of rows < lq_real is written (1 <= lk_real, lq_real <= lp).
// o is a contiguous [b, lp, h*dh] buffer, bf16, or f32 when o_f32 != 0.
// dh in {16, 32, 64}.
extern "C" int odgs_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int lp, int h, int dh, int lk_real, int lq_real, float scale,
    long long q_sb, long long q_sl, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, int smax, int o_f32, void* stream) {
  if (b == 0 || lp == 0 || h == 0) return 0;
  if (lk_real < 1 || lk_real > lp || lq_real < 1 || lq_real > lp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smax && lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, o, lse, b, lp, h, lk_real, lq_real, scale,
                        q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, smax != 0,
                        o_f32 != 0, s);
    case 32:
      return launch<32>(q, k, v, o, lse, b, lp, h, lk_real, lq_real, scale,
                        q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, smax != 0,
                        o_f32 != 0, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, lp, h, lk_real, lq_real, scale,
                        q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, smax != 0,
                        o_f32 != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
