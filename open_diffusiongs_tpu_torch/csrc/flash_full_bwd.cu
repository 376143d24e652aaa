// Exact multi-head attention backward on the [b, l, h, d] layout (#5b).
//
// The backward of the general route's training function, whose forward is
// flash_full_fwd.cu's STATS flag (#5s).  It has no Pallas counterpart: JAX
// differentiates that route through splash (open_diffusiongs_tpu/models/
// transformer.py::_flash_fwd_splash_bwd :116-152, the custom_vjp whose
// forward and backward rules are splash on `q * d^-1/2`, _ffsb_fwd
// :141-146), a JAX library kernel; this file takes the place of splash's
// backward.  Same algebra, natural-base scores in the exp2 domain:
//   q~ = bf16(q * bf16(d^-1/2))             (formed once by the caller, as
//                                             the forward forms it)
//   P  = exp2(log2 e * (q~ . k) - lse)      (lse: #5s's base-2 lse)
//   dP = dO . v,  dS = P * (dP - delta)     (delta = rowsum(dO * O), given)
//   dq = bf16(d^-1/2) * dS . K,  dk = dS^T . q~,  dv = P^T . dO
// f32 accumulation; P and dS are rounded to bf16 as the tensor cores' A
// operand.  q/dO hold lq rows, k/v lk rows (lk may differ: the second half
// of subset attention).  Keys >= lk contribute nothing (TMA reads their K/V
// rows as 0, P forced to 0); query rows >= lq contribute nothing (TMA reads
// their q~/dO rows and lse/delta as 0, P forced to 0); no output row past
// lq / lk is written.  Any head width d <= 64: tiles DH of 16, 32 or 64,
// TMA zero-fills the columns >= d, which add nothing to q~.k or dO.v, and
// the columns >= d of dq / dk / dv are never stored; also d <= 128 (DH =
// 128, below).
//
// What bounds it: at b = 4, L = 4098, h = 16, d = 64 the pair runs 7
// products of 2 L^2 d per head (S and dP in both kernels, then dQ, dK, dV),
// 5 of them (0.69 TFLOP, 0.70 ms at 989 TFLOP/s bf16) the least the
// function needs, beside ~1.1e9 exp2 (both kernels rebuild P).  Bound by
// tensor-core throughput; the bytes (~50 MB) take 0.015 ms.
//
// Design: csrc/flash_attn_bwd.cu's (the packed route's backward), on
// csrc/hopper.cuh, with flash_full_fwd.cu's 4-D tensor maps:
//   * two kernels, dQ (one block per 128 q rows, head, batch; K/V
//     streamed) and dK/dV (one block per 128 keys, head, batch; q~, dO,
//     lse, delta streamed), with plain stores only: no output element is
//     written by two threads and every sum runs in a fixed order, so the
//     backward is deterministic;
//   * a producer warpgroup (one thread issues TMA; setmaxnreg 40) and two
//     consumer warpgroups of 64 rows each (setmaxnreg 232); streamed 64-row
//     tiles through a ring of NSTAGE stages with full / empty mbarriers;
//   * q~, dO, k and v are read through 4-D maps {d, h, rows, b} with each
//     tensor's own strides, in one-head boxes [64, DH]
//     (make_map_heads_bf16); lse and delta through 2-D maps of the
//     [b*h, pitch] f32 layout, a tile's 64 values one box;
//   * every operand orientation comes from wgmma's transpose bit:
//       dQ: S = q~.K^T, dP = dO.V^T (A = q~ / dO in registers, B = K / V
//       K-major), dQ += dS.K (dS as register A, K MN-major);
//       dK/dV: S^T = K.q~^T, dP^T = V.dO^T (A = K / V from shared memory,
//       B = q~ / dO K-major), dV += P^T.dO and dK += dS^T.q~ (P^T and
//       dS^T straight from the accumulators as register A, dO and q~
//       MN-major);
//   * overlap within each warpgroup: tile j+1's score products are issued
//     before tile j's accumulating products and the exp2 work of j+1 runs
//     while those are on the tensor cores (P / dS fragments double-
//     buffered).
// Wide heads, 64 < d <= 128 (DH = 128; the splash route, ops/attention.py::
// splash_attention): tiles are stored span by span (csrc/hopper.cuh,
// span_of) and read by the single-span descriptors; every product whose N
// is the head width runs one m64n64 wgmma per span.  Two changes keep the
// consumers' registers where they are at DH = 64 (ptxas' report, kept
// beside the library, shows the spills):
//   * dQ takes q~ and dO as shared-memory A operands (ss) instead of
//     register fragments, which would add 64 registers beside dq's 64;
//   * dK/dV splits the output columns: a block owns 128 keys and ONE
//     64-column span of dk / dv (grid.x = 2 x the key blocks), so its two
//     accumulators stay 2 x 32 registers.  Both span blocks rebuild S^T
//     and dP^T over all 128 columns: the pair runs 9 products of
//     2 L^2 d per head instead of 7 (+29 %); the P / dS double-buffering
//     is kept.
// Outputs are new contiguous tensors, dq [b, lq, h, d] and dk / dv
// [b, lk, h, d].

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace odgs;

constexpr int WG = 128;          // threads per warpgroup
constexpr int ROWS = 64;         // rows per consumer warpgroup = tile rows
constexpr int BLOCK = 2 * ROWS;  // resident rows per block
constexpr int NSTAGE = 3;
constexpr int NTHREADS = 3 * WG; // consumers 0 and 1, producer 2
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  CUtensorMap tq, tdo, tk, tv;   // one-head boxes [ROWS, DH]
  CUtensorMap tlse, tdlt;        // boxes of [1, ROWS], columns < lq
  const float *lse, *delta;      // [b*h, pitch] f32
  __nv_bfloat16 *dq, *dk, *dv;   // contiguous [b, rows, h, d]
  int lq, lk, h, d, pitch;
  float dq_scale;                // bf16(d^-1/2)
};

template <int DH>
struct DqSmem {
  alignas(1024) __nv_bfloat16 q[BLOCK * DH];     // q~, resident
  alignas(1024) __nv_bfloat16 d[BLOCK * DH];     // dO, resident
  alignas(1024) __nv_bfloat16 k[NSTAGE][ROWS * DH];
  alignas(1024) __nv_bfloat16 v[NSTAGE][ROWS * DH];
  uint64_t full[NSTAGE], empty[NSTAGE], res;
};

template <int DH>
struct DkvSmem {
  alignas(1024) __nv_bfloat16 k[BLOCK * DH];     // resident
  alignas(1024) __nv_bfloat16 v[BLOCK * DH];     // resident
  alignas(1024) __nv_bfloat16 q[NSTAGE][ROWS * DH];
  alignas(1024) __nv_bfloat16 d[NSTAGE][ROWS * DH];
  alignas(128) float lse[NSTAGE][ROWS];
  alignas(128) float dlt[NSTAGE][ROWS];
  uint64_t full[NSTAGE], empty[NSTAGE], res;
};

// Element e of n8 tile n of a 64-column accumulator sits in A fragment
// [n / 2][2 * (n % 2) + e / 2] of the k16 steps (the pair e, e + 1 packed):
// the mma.sync C layout of two adjacent n8 tiles is the A layout of one k16.
__device__ __forceinline__ uint32_t& frag_of(uint32_t (&f)[ROWS / 16][4],
                                            int n, int e) {
  return f[n / 2][2 * (n % 2) + e / 2];
}

// Write this thread's rows row0, row0 + 8 (those < rows) and columns < d
// of a [64, DH] accumulator holding columns c0 .. c0 + DH - 1, scaled, into
// head `head` of batch element bi of a contiguous [b, rows, h, d] tensor.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int bi,
                                           int head, int rows, int h, int d,
                                           int row0,
                                           const float (&acc)[DH / 2],
                                           float scale, int t4, int c0 = 0) {
  const bool pairs = (d & 1) == 0;   // column pairs 4-byte aligned
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = c0 + n * 8 + 2 * t4;
    if (c >= d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r >= rows) continue;
      __nv_bfloat16* dst =
          out + (((long long)bi * rows + r) * h + head) * d + c;
      const float x0 = acc[4 * n + 2 * half] * scale;
      const float x1 = acc[4 * n + 2 * half + 1] * scale;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (c + 1 < d) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DH>
__device__ __forceinline__ void zero_acc(float (&acc)[DH / 2]) {
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
}

// ---------------------------------------------------------------------------
// dQ: one block per (128 q rows, head, batch).
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void dq_consumer(const BwdParams& p, DqSmem<DH>& s,
                                            int wg, int q0, int head, int bi,
                                            int n_kt) {
  constexpr int KSTEPS = DH / 16;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + wg * ROWS + warp * 16 + g;   // rows r0 and r0 + 8
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const long long o = (long long)(bi * p.h + head) * p.pitch + r;
    lse_r[half] = r < p.lq ? p.lse[o] : 0.f;
    dlt_r[half] = r < p.lq ? p.delta[o] : 0.f;
  }
  const bool real_r[2] = {r0 < p.lq, r0 + 8 < p.lq};
  float dq[DH / 2], sacc[ROWS / 2], pacc[ROWS / 2];
  typedef uint32_t Frags[ROWS / 16][4];
  Frags ds0, ds1;   // dS of two tiles
  // q~ and dO as register A for DH <= 64; from shared memory for DH = 128
  // (A_SMEM), whose 64 registers of fragments would not fit beside dq
  constexpr bool A_SMEM = DH > 64;
  uint32_t qf[A_SMEM ? 1 : KSTEPS][4], df[A_SMEM ? 1 : KSTEPS][4];
  const __nv_bfloat16* qt = s.q + wg * ROWS * DH;   // this warpgroup's rows
  const __nv_bfloat16* dt = s.d + wg * ROWS * DH;
  zero_acc<DH>(dq);

  auto wait_full = [&](int j) {
    mbar_wait(&s.full[j % NSTAGE], (j / NSTAGE) & 1);
  };
  auto issue_scores = [&](int j) {   // S = q~ . K^T, dP = dO . V^T
    const int st = j % NSTAGE;
    if constexpr (A_SMEM) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<ROWS>::template ss<0>(sacc, kdesc_tile<DH>(qt, ROWS, kk),
                                    kdesc_tile<DH>(s.k[st], ROWS, kk),
                                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<ROWS>::template ss<0>(pacc, kdesc_tile<DH>(dt, ROWS, kk),
                                    kdesc_tile<DH>(s.v[st], ROWS, kk),
                                    kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<ROWS>::template rs<0>(sacc, qf[kk],
                                    kdesc_tile<DH>(s.k[st], ROWS, kk),
                                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<ROWS>::template rs<0>(pacc, df[kk],
                                    kdesc_tile<DH>(s.v[st], ROWS, kk),
                                    kk > 0);
    }
    wgmma_commit();
  };
  auto issue_grad = [&](int j, const Frags& dsf) {
#pragma unroll
    for (int kj = 0; kj < ROWS / 16; ++kj)   // dQ += dS . K (K MN-major)
      mma_mn<DH>(dq, dsf[kj], s.k[j % NSTAGE], ROWS, kj);
    wgmma_commit();
  };
  auto make_ds = [&](int j, Frags& dsf) {
    fence_regs(sacc);
    fence_regs(pacc);
    const int k0 = j * ROWS;
#pragma unroll
    for (int n = 0; n < ROWS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int key = k0 + 8 * n + 2 * t4, half = e / 2;
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // exp2(-inf) = 0 drops the keys >= lk and rows >= lq
          const float pv = exp2f(
              (key + c < p.lk && real_r[half])
                  ? fmaf(sacc[4 * n + e + c], LOG2E, -lse_r[half])
                  : -INFINITY);
          ds[c] = pv * (pacc[4 * n + e + c] - dlt_r[half]);
        }
        frag_of(dsf, n, e) = pack_bf16x2(ds[0], ds[1]);
      }
  };
  // Tile j+1's score products run ahead of tile j's dQ product, so the
  // exp2 work of j+1 overlaps dQ += dS_j . K_j on the tensor cores.
  auto step = [&](int j, const Frags& cur, Frags& nxt) {   // j + 1 < n_kt
    wait_full(j + 1);
    wgmma_fence();
    issue_scores(j + 1);
    issue_grad(j, cur);
    wgmma_wait<1>();
    if (j > 0 && tid == 0) mbar_arrive(&s.empty[(j - 1) % NSTAGE]);
    make_ds(j + 1, nxt);
  };
  auto last = [&](int j, const Frags& cur) {
    wgmma_fence();
    issue_grad(j, cur);
    wgmma_wait<0>();
  };

  mbar_wait(&s.res, 0);
  if constexpr (!A_SMEM) {
    load_a_frags_tile<DH>(qt, ROWS, warp * 16 + g, t4, qf);
    load_a_frags_tile<DH>(dt, ROWS, warp * 16 + g, t4, df);
  }
  wait_full(0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  make_ds(0, ds0);
  int j = 0;
  for (; j + 2 < n_kt; j += 2) {
    step(j, ds0, ds1);
    step(j + 1, ds1, ds0);
  }
  if (j + 1 < n_kt) {
    step(j, ds0, ds1);
    last(j + 1, ds1);
  } else {
    last(j, ds0);
  }
  fence_regs(dq);
  store_rows<DH>(p.dq, bi, head, p.lq, p.h, p.d, r0, dq, p.dq_scale, t4);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_full_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DqSmem<DH>& s = smem_storage<DqSmem<DH>>(smem_raw);
  const int q0 = blockIdx.x * BLOCK, head = blockIdx.y, bi = blockIdx.z;
  const int wg = threadIdx.x / WG;
  const int n_active = q0 + ROWS < p.lq ? 2 : 1;   // consumers with rows < lq
  const int n_kt = (p.lk + ROWS - 1) / ROWS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], n_active);
    }
    mbar_init(&s.res, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(&s.res, 2 * BLOCK * DH * 2);
      for (int r = 0; r < BLOCK; r += ROWS) {
        tma_load_heads<DH>(s.q + r * DH, &p.tq, &s.res, head, q0 + r, bi,
                           ROWS);
        tma_load_heads<DH>(s.d + r * DH, &p.tdo, &s.res, head, q0 + r, bi,
                           ROWS);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % NSTAGE;
        mbar_wait(&s.empty[st], ((j / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * ROWS * DH * 2);
        tma_load_heads<DH>(s.k[st], &p.tk, &s.full[st], head, j * ROWS, bi,
                           ROWS);
        tma_load_heads<DH>(s.v[st], &p.tv, &s.full[st], head, j * ROWS, bi,
                           ROWS);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg < n_active) dq_consumer<DH>(p, s, wg, q0, head, bi, n_kt);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (128 keys, head, batch), in the transposed
// orientation (rows = keys).
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void dkv_consumer(const BwdParams& p,
                                             DkvSmem<DH>& s, int wg, int k0,
                                             int cs, int head, int bi,
                                             int n_qt) {
  constexpr int KSTEPS = DH / 16;
  constexpr int OC = span_of<DH>();   // output columns of this block
  typedef uint32_t Frags[ROWS / 16][4];
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = k0 + wg * ROWS + warp * 16 + g;   // keys r0 and r0 + 8
  float dk[OC / 2], dv[OC / 2], sacc[ROWS / 2], pacc[ROWS / 2];
  Frags pf0, ds0, pf1, ds1;   // P^T and dS^T of two tiles
  zero_acc<OC>(dk);
  zero_acc<OC>(dv);
  const __nv_bfloat16* kt = s.k + wg * ROWS * DH;   // this warpgroup's keys
  const __nv_bfloat16* vt = s.v + wg * ROWS * DH;

  auto wait_full = [&](int j) {
    mbar_wait(&s.full[j % NSTAGE], (j / NSTAGE) & 1);
  };
  auto issue_scores = [&](int j) {   // S^T = K . q~^T, dP^T = V . dO^T
    const int st = j % NSTAGE;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<ROWS>::template ss<0>(sacc, kdesc_tile<DH>(kt, ROWS, kk),
                                  kdesc_tile<DH>(s.q[st], ROWS, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<ROWS>::template ss<0>(pacc, kdesc_tile<DH>(vt, ROWS, kk),
                                  kdesc_tile<DH>(s.d[st], ROWS, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_grads = [&](int j, const Frags& pf, const Frags& dsf) {
    const int st = j % NSTAGE;
#pragma unroll
    for (int kj = 0; kj < ROWS / 16; ++kj)   // dV += P^T . dO (MN-major)
      Wgmma<OC>::template rs<1>(dv, pf[kj],
                                mndesc_tile<DH>(s.d[st], ROWS, cs, kj), 1);
#pragma unroll
    for (int kj = 0; kj < ROWS / 16; ++kj)   // dK += dS^T . q~ (MN-major)
      Wgmma<OC>::template rs<1>(dk, dsf[kj],
                                mndesc_tile<DH>(s.q[st], ROWS, cs, kj), 1);
    wgmma_commit();
  };
  auto make_frags = [&](int j, Frags& pf, Frags& dsf) {
    fence_regs(sacc);
    fence_regs(pacc);
    const int st = j % NSTAGE, q0 = j * ROWS;
#pragma unroll
    for (int n = 0; n < ROWS / 8; ++n) {
      const int col = 8 * n + 2 * t4;   // q rows col, col + 1 of the tile
      const float2 lse2 = *reinterpret_cast<const float2*>(&s.lse[st][col]);
      const float2 dlt2 = *reinterpret_cast<const float2*>(&s.dlt[st][col]);
      const float lse_c[2] = {lse2.x, lse2.y}, dlt_c[2] = {dlt2.x, dlt2.y};
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float pv[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pv[c] = exp2f(q0 + col + c < p.lq
                            ? fmaf(sacc[4 * n + e + c], LOG2E, -lse_c[c])
                            : -INFINITY);
          ds[c] = pv[c] * (pacc[4 * n + e + c] - dlt_c[c]);   // dS^T
        }
        frag_of(pf, n, e) = pack_bf16x2(pv[0], pv[1]);
        frag_of(dsf, n, e) = pack_bf16x2(ds[0], ds[1]);
      }
    }
  };
  // Tile j+1's score products run ahead of tile j's dV / dK products, so
  // the exp2 work of j+1 overlaps them on the tensor cores.
  auto step = [&](int j, const Frags& pf, const Frags& dsf, Frags& pf_n,
                  Frags& dsf_n) {   // j + 1 < n_qt
    wait_full(j + 1);
    wgmma_fence();
    issue_scores(j + 1);
    issue_grads(j, pf, dsf);
    wgmma_wait<1>();
    if (j > 0 && tid == 0) mbar_arrive(&s.empty[(j - 1) % NSTAGE]);
    make_frags(j + 1, pf_n, dsf_n);
  };
  auto last = [&](int j, const Frags& pf, const Frags& dsf) {
    wgmma_fence();
    issue_grads(j, pf, dsf);
    wgmma_wait<0>();
  };

  mbar_wait(&s.res, 0);
  wait_full(0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  make_frags(0, pf0, ds0);
  int j = 0;
  for (; j + 2 < n_qt; j += 2) {
    step(j, pf0, ds0, pf1, ds1);
    step(j + 1, pf1, ds1, pf0, ds0);
  }
  if (j + 1 < n_qt) {
    step(j, pf0, ds0, pf1, ds1);
    last(j + 1, pf1, ds1);
  } else {
    last(j, pf0, ds0);
  }
  fence_regs(dk);
  fence_regs(dv);
  store_rows<OC>(p.dk, bi, head, p.lk, p.h, p.d, r0, dk, 1.f, t4, cs * OC);
  store_rows<OC>(p.dv, bi, head, p.lk, p.h, p.d, r0, dv, 1.f, t4, cs * OC);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_full_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DkvSmem<DH>& s = smem_storage<DkvSmem<DH>>(smem_raw);
  constexpr int NCS = DH / span_of<DH>();   // column slices, one a block
  const int k0 = blockIdx.x / NCS * BLOCK, cs = blockIdx.x % NCS;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int wg = threadIdx.x / WG;
  const int n_active = k0 + ROWS < p.lk ? 2 : 1;   // consumers with keys < lk
  const int n_qt = (p.lq + ROWS - 1) / ROWS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], n_active);
    }
    mbar_init(&s.res, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(&s.res, 2 * BLOCK * DH * 2);
      for (int r = 0; r < BLOCK; r += ROWS) {
        tma_load_heads<DH>(s.k + r * DH, &p.tk, &s.res, head, k0 + r, bi,
                           ROWS);
        tma_load_heads<DH>(s.v + r * DH, &p.tv, &s.res, head, k0 + r, bi,
                           ROWS);
      }
      const int stats_row = bi * p.h + head;
      for (int j = 0; j < n_qt; ++j) {
        const int st = j % NSTAGE;
        mbar_wait(&s.empty[st], ((j / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * ROWS * DH * 2 + 2 * ROWS * 4);
        tma_load_heads<DH>(s.q[st], &p.tq, &s.full[st], head, j * ROWS, bi,
                           ROWS);
        tma_load_heads<DH>(s.d[st], &p.tdo, &s.full[st], head, j * ROWS, bi,
                           ROWS);
        tma_load_2d(s.lse[st], &p.tlse, &s.full[st], j * ROWS, stats_row);
        tma_load_2d(s.dlt[st], &p.tdlt, &s.full[st], j * ROWS, stats_row);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg < n_active) dkv_consumer<DH>(p, s, wg, k0, cs, head, bi, n_qt);
  }
}

template <typename Smem>
int set_smem(const void* kern) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<Smem>()));
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           int b, int dm, long long q_sb, long long q_sl, long long q_sh,
           long long k_sb, long long k_sl, long long k_sh, long long v_sb,
           long long v_sl, long long v_sh, long long do_sb, long long do_sl,
           long long do_sh, BwdParams& p, cudaStream_t stream) {
  const bool ok =
      make_map_heads_bf16<DH>(&p.tq, q, dm, p.h, p.lq, b, q_sh, q_sl, q_sb,
                              ROWS) &&
      make_map_heads_bf16<DH>(&p.tdo, dout, dm, p.h, p.lq, b, do_sh, do_sl,
                              do_sb, ROWS) &&
      make_map_heads_bf16<DH>(&p.tk, k, dm, p.h, p.lk, b, k_sh, k_sl, k_sb,
                              ROWS) &&
      make_map_heads_bf16<DH>(&p.tv, v, dm, p.h, p.lk, b, v_sh, v_sl, v_sb,
                              ROWS) &&
      make_map_f32(&p.tlse, p.lse, p.lq, p.pitch, b * p.h, ROWS) &&
      make_map_f32(&p.tdlt, p.delta, p.lq, p.pitch, b * p.h, ROWS);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    int e = set_smem<DqSmem<DH>>(
        reinterpret_cast<const void*>(flash_full_bwd_dq_kernel<DH>));
    if (e == 0)
      e = set_smem<DkvSmem<DH>>(
          reinterpret_cast<const void*>(flash_full_bwd_dkv_kernel<DH>));
    if (e != 0) return e;
    configured = true;
  }
  flash_full_bwd_dq_kernel<DH>
      <<<dim3((p.lq + BLOCK - 1) / BLOCK, p.h, b), NTHREADS,
         smem_bytes<DqSmem<DH>>(), stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_full_bwd_dkv_kernel<DH>
      <<<dim3((p.lk + BLOCK - 1) / BLOCK * (DH / span_of<DH>()), p.h, b),
         NTHREADS,
         smem_bytes<DkvSmem<DH>>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream`; returns the first failing launch's
// cudaError_t (0 = success).  q is q~ = bf16(q * bf16(d^-1/2)), formed by
// the caller; q / dout [b, lq, h, *] and k / v [b, lk, h, *] bf16 views
// read through (batch, row, head) strides in elements, last dimension
// contiguous; the maps read `dm` columns (d <= dm <= the tile width 16 / 32
// / 64 / 128; dm > d for the wrapper's zero-padded copies), under TMA's rule
// (ops/attention.py::full_takes_view).  lse and delta: f32 [b, h, pitch],
// pitch = lq rounded up to a multiple of 4 (ops/attention.py::stats_pitch),
// columns < lq read.  dq [b, lq, h, d] and dk / dv [b, lk, h, d]:
// contiguous bf16 outputs.  dq_scale = bf16(d^-1/2).  Any d in 1..128
// (tiles 16 / 32 / 64 / 128).
extern "C" int odgs_flash_full_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int lq, int lk, int h, int d, int dm, float dq_scale, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    long long do_sb, long long do_sl, long long do_sh, void* stream) {
  if (b == 0 || h == 0 || lq == 0 || lk == 0) return 0;
  const int tile = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (d < 1 || d > 128 || dm < d || dm > tile)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lq = lq;
  p.lk = lk;
  p.h = h;
  p.d = d;
  p.pitch = (lq + 3) / 4 * 4;
  p.dq_scale = dq_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ODGS_BWD_ARGS                                                       \
  q, k, v, dout, b, dm, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl,     \
      v_sh, do_sb, do_sl, do_sh, p, s
  if (tile == 16) return launch<16>(ODGS_BWD_ARGS);
  if (tile == 32) return launch<32>(ODGS_BWD_ARGS);
  if (tile == 64) return launch<64>(ODGS_BWD_ARGS);
  return launch<128>(ODGS_BWD_ARGS);
#undef ODGS_BWD_ARGS
}
