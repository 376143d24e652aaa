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
// Keys >= lk_real are excluded (TMA reads their K/V rows as 0, P forced to
// 0); q rows >= lq_real contribute nothing (TMA reads their q~/dO rows as 0,
// P and dS forced to 0); dq rows >= lq_real and dk / dv rows >= lk_real are
// written as exactly 0.  The two extents are separate for the ring steps of
// sequence parallelism (parallel/ring.py), where a query shard meets a key
// shard with another number of real rows; one extent l_real for both is
// lq_real = lk_real = l_real.
// The caller forms q~ once (ops/attention.py, the `_prescaled_q` rule), so
// TMA reads it as it is.
//
// What bounds it: at the train path's shape (b = 4, L = 4098, h = 16,
// dh = 64) the pair runs 7 products of 2·L²·dh per head (S and dP in both
// kernels, then dQ, dK, dV), ≈ 963 GFLOP executed, 5 of them (≈ 688
// GFLOP, 0.70 ms at 989 TFLOP/s bf16) the least the function needs; its
// ≈ 1.07e9 exp2 (both kernels rebuild P) take ≈ 0.27 ms on the SFUs.
// Bound by tensor-core throughput.
//
// Design: the TPU's two-kernel split, which keeps the backward
// deterministic with plain stores (no output element is written by more than
// one thread, every sum runs in a fixed order), each kernel with
// FlashAttention-3's warp-specialised shape:
//   * one producer warpgroup (one thread issues TMA; setmaxnreg 40) and
//     two consumer warpgroups of 64 rows each (setmaxnreg 232);
//   * the block's resident tiles are loaded once, the streamed 64-row tiles
//     run through a ring of NSTAGE stages with full / empty mbarriers;
//     the tensor maps are those of the forward (3-D {h*dh, rows, b}, row
//     extent lq_real for q~ / dO and lk_real for K / V, swizzle = the row's
//     width), plus 2-D maps of lse and
//     delta laid out [b*h, pitch] so a q tile's 64 values are one box;
//   * every operand orientation comes from wgmma's transpose bit, never
//     from a transposed copy in shared memory:
//       dQ kernel (q~ and dO resident, K/V streamed):
//         S = q~.K^T and dP = dO.V^T, A = q~ / dO (loaded once from the
//         resident tiles into registers), B = K / V (K-major);
//         dQ += dS.K, dS from registers as A, K read MN-major;
//       dK/dV kernel (K and V resident, q~/dO/lse/delta streamed):
//         S^T = K.q~^T and dP^T = V.dO^T, A = K / V, B = q~ / dO (K-major);
//         dV += P^T.dO and dK += dS^T.q~, P^T and dS^T straight from the
//         accumulators as register A, dO and q~ read MN-major.
//   * Overlap, within each warpgroup: at streamed tile j it issues tile
//     j+1's two score products and then tile j's accumulating products
//     (dQ, or dV and dK) as two commit groups, waits for the scores only,
//     and rebuilds P and dS of tile j+1 (the exp2 work) while tile j's
//     products still run; P / dS fragments are double-buffered for that.
//     The two consumer warpgroups run independently, so one's exp2 work
//     also overlaps the other's products.
// Inputs q~/k/v may be column slices of one fused qkv projection, and the
// outputs dq/dk/dv column slices of one fused [b, Lp, 3*h*dh] gradient:
// each is addressed by its own batch and row strides.  The outputs are
// bf16, or f32 with `out_f32`: a ring step of sequence parallelism
// (parallel/ring.py) yields one part of dq (its keys' slice) and of dk / dv
// (its queries' shard), and the parts are summed across steps before the
// one rounding to bf16.  Within one slice's keys, Σ_j dS_ij is not 0, so
// parts rounded to bf16 first would cancel away their bits.

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
constexpr float LN2 = 0.6931471805599453f;

// Rows of the [b*h, pitch] f32 lse / delta layout: a multiple of 4, so a
// row starts 16-byte aligned for TMA (ops/attention.py::stats_pitch).
__host__ __device__ inline int stats_pitch(int lp) { return (lp + 3) / 4 * 4; }

struct BwdParams {
  CUtensorMap tq, tdo;           // boxes of [ROWS, dh], rows < lq_real
  CUtensorMap tk, tv;            // boxes of [ROWS, dh], rows < lk_real
  CUtensorMap tlse, tdlt;        // boxes of [1, ROWS], columns < lq_real
  const float *lse, *delta;      // [b*h, pitch] f32
  void *dq, *dk, *dv;            // bf16, or f32 with out_f32
  int lp, h, lq_real, lk_real, pitch, out_f32;
  float dq_scale;                // dh^-1/2
  long long dq_sb, dq_sl, dk_sb, dk_sl, dv_sb, dv_sl;
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

// Write this thread's rows row0, row0 + 8 of a [64, DH] accumulator, scaled
// (rows >= extent as 0, rows >= lp skipped), at element `off` of `out` (the
// (batch, head) column block), as bf16 or, with `f32`, f32.
template <int DH>
__device__ __forceinline__ void store_rows(void* out, long long off,
                                           long long sl, int row0, int lp,
                                           int extent,
                                           const float (&acc)[DH / 2],
                                           float scale, int t4, bool f32) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r >= lp) continue;
      const bool real = r < extent;
      const float a = real ? acc[4 * n + 2 * half] * scale : 0.f;
      const float b = real ? acc[4 * n + 2 * half + 1] * scale : 0.f;
      const long long e = off + (long long)r * sl + c;
      if (f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + e) =
            make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + e) =
            pack_bf16x2(a, b);
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
    lse_r[half] = r < p.lq_real ? p.lse[o] : 0.f;
    dlt_r[half] = r < p.lq_real ? p.delta[o] : 0.f;
  }
  const bool real_r[2] = {r0 < p.lq_real, r0 + 8 < p.lq_real};
  float dq[DH / 2], sacc[ROWS / 2], pacc[ROWS / 2];
  typedef uint32_t Frags[ROWS / 16][4];
  Frags ds0, ds1;   // dS of two tiles
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];   // q~ and dO as register A
  zero_acc<DH>(dq);

  auto wait_full = [&](int j) {
    mbar_wait(&s.full[j % NSTAGE], (j / NSTAGE) & 1);
  };
  auto issue_scores = [&](int j) {   // S = q~ . K^T, dP = dO . V^T
    const int st = j % NSTAGE;
    const uint64_t kd = make_desc<DH>(s.k[st]), vd = make_desc<DH>(s.v[st]);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<ROWS>::template rs<0>(sacc, qf[kk], desc_add(kd, kk * 32),
                                  kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<ROWS>::template rs<0>(pacc, df[kk], desc_add(vd, kk * 32),
                                  kk > 0);
    wgmma_commit();
  };
  auto issue_grad = [&](int j, const Frags& dsf) {
    const uint64_t kd = make_desc<DH>(s.k[j % NSTAGE]);
#pragma unroll
    for (int kj = 0; kj < ROWS / 16; ++kj)   // dQ += dS . K (K MN-major)
      Wgmma<DH>::template rs<1>(dq, dsf[kj],
                                desc_add(kd, kj * 16 * DH * 2), 1);
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
          // exp2(-inf) = 0 drops the pad keys and rows without a branch
          const float pv = exp2f((key + c < p.lk_real && real_r[half])
                                     ? sacc[4 * n + e + c] - lse_r[half]
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
  load_a_frags<DH>(s.q, wg * ROWS + warp * 16 + g, t4, qf);
  load_a_frags<DH>(s.d, wg * ROWS + warp * 16 + g, t4, df);
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
  store_rows<DH>(p.dq, bi * p.dq_sb + head * DH, p.dq_sl, r0, p.lp,
                 p.lq_real, dq, p.dq_scale, t4, p.out_f32);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DqSmem<DH>& s = smem_storage<DqSmem<DH>>(smem_raw);
  const int q0 = blockIdx.x * BLOCK, head = blockIdx.y, bi = blockIdx.z;
  const int wg = threadIdx.x / WG;
  // consumers whose rows hold a real q row; the others only write zeros
  const int n_active = q0 >= p.lq_real ? 0 : q0 + ROWS < p.lq_real ? 2 : 1;
  const int n_kt = n_active > 0 ? (p.lk_real + ROWS - 1) / ROWS : 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], n_active > 0 ? n_active : 1);
    }
    mbar_init(&s.res, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG && n_active > 0) {
      mbar_expect_tx(&s.res, 2 * BLOCK * DH * 2);
      for (int r = 0; r < BLOCK; r += ROWS) {
        tma_load_3d(s.q + r * DH, &p.tq, &s.res, head * DH, q0 + r, bi);
        tma_load_3d(s.d + r * DH, &p.tdo, &s.res, head * DH, q0 + r, bi);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % NSTAGE;
        mbar_wait(&s.empty[st], ((j / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * ROWS * DH * 2);
        tma_load_3d(s.k[st], &p.tk, &s.full[st], head * DH, j * ROWS, bi);
        tma_load_3d(s.v[st], &p.tv, &s.full[st], head * DH, j * ROWS, bi);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg < n_active) {
      dq_consumer<DH>(p, s, wg, q0, head, bi, n_kt);
    } else {   // every row of this warpgroup is >= lq_real: write zeros
      const int tid = threadIdx.x % WG;
      const int r0 = q0 + wg * ROWS + (tid / 32) * 16 + (tid % 32) / 4;
      float zero[DH / 2];
      zero_acc<DH>(zero);
      store_rows<DH>(p.dq, bi * p.dq_sb + head * DH, p.dq_sl, r0, p.lp,
                     p.lq_real, zero, 0.f, tid % 4, p.out_f32);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (128 keys, head, batch), in the transposed
// orientation (rows = keys).
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void dkv_consumer(const BwdParams& p,
                                             DkvSmem<DH>& s, int wg, int k0,
                                             int head, int bi, int n_qt) {
  constexpr int KSTEPS = DH / 16;
  typedef uint32_t Frags[ROWS / 16][4];
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = k0 + wg * ROWS + warp * 16 + g;   // keys r0 and r0 + 8
  float dk[DH / 2], dv[DH / 2], sacc[ROWS / 2], pacc[ROWS / 2];
  Frags pf0, ds0, pf1, ds1;   // P^T and dS^T of two tiles
  zero_acc<DH>(dk);
  zero_acc<DH>(dv);
  const uint64_t kd = make_desc<DH>(s.k + wg * ROWS * DH);
  const uint64_t vd = make_desc<DH>(s.v + wg * ROWS * DH);

  auto wait_full = [&](int j) {
    mbar_wait(&s.full[j % NSTAGE], (j / NSTAGE) & 1);
  };
  auto issue_scores = [&](int j) {   // S^T = K . q~^T, dP^T = V . dO^T
    const int st = j % NSTAGE;
    const uint64_t qd = make_desc<DH>(s.q[st]), dd = make_desc<DH>(s.d[st]);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<ROWS>::template ss<0>(sacc, desc_add(kd, kk * 32),
                                  desc_add(qd, kk * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<ROWS>::template ss<0>(pacc, desc_add(vd, kk * 32),
                                  desc_add(dd, kk * 32), kk > 0);
    wgmma_commit();
  };
  auto issue_grads = [&](int j, const Frags& pf, const Frags& dsf) {
    const int st = j % NSTAGE;
    const uint64_t qd = make_desc<DH>(s.q[st]), dd = make_desc<DH>(s.d[st]);
#pragma unroll
    for (int kj = 0; kj < ROWS / 16; ++kj)   // dV += P^T . dO (MN-major)
      Wgmma<DH>::template rs<1>(dv, pf[kj], desc_add(dd, kj * 16 * DH * 2), 1);
#pragma unroll
    for (int kj = 0; kj < ROWS / 16; ++kj)   // dK += dS^T . q~ (MN-major)
      Wgmma<DH>::template rs<1>(dk, dsf[kj], desc_add(qd, kj * 16 * DH * 2),
                                1);
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
          pv[c] = exp2f(q0 + col + c < p.lq_real
                            ? sacc[4 * n + e + c] - lse_c[c] : -INFINITY);
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
  store_rows<DH>(p.dk, bi * p.dk_sb + head * DH, p.dk_sl, r0, p.lp,
                 p.lk_real, dk, LN2, t4, p.out_f32);
  store_rows<DH>(p.dv, bi * p.dv_sb + head * DH, p.dv_sl, r0, p.lp,
                 p.lk_real, dv, 1.f, t4, p.out_f32);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DkvSmem<DH>& s = smem_storage<DkvSmem<DH>>(smem_raw);
  const int k0 = blockIdx.x * BLOCK, head = blockIdx.y, bi = blockIdx.z;
  const int wg = threadIdx.x / WG;
  const int n_active = k0 >= p.lk_real ? 0 : k0 + ROWS < p.lk_real ? 2 : 1;
  const int n_qt = n_active > 0 ? (p.lq_real + ROWS - 1) / ROWS : 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], n_active > 0 ? n_active : 1);
    }
    mbar_init(&s.res, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG && n_active > 0) {
      mbar_expect_tx(&s.res, 2 * BLOCK * DH * 2);
      for (int r = 0; r < BLOCK; r += ROWS) {
        tma_load_3d(s.k + r * DH, &p.tk, &s.res, head * DH, k0 + r, bi);
        tma_load_3d(s.v + r * DH, &p.tv, &s.res, head * DH, k0 + r, bi);
      }
      const int stats_row = bi * p.h + head;
      for (int j = 0; j < n_qt; ++j) {
        const int st = j % NSTAGE;
        mbar_wait(&s.empty[st], ((j / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * ROWS * DH * 2 + 2 * ROWS * 4);
        tma_load_3d(s.q[st], &p.tq, &s.full[st], head * DH, j * ROWS, bi);
        tma_load_3d(s.d[st], &p.tdo, &s.full[st], head * DH, j * ROWS, bi);
        tma_load_2d(s.lse[st], &p.tlse, &s.full[st], j * ROWS, stats_row);
        tma_load_2d(s.dlt[st], &p.tdlt, &s.full[st], j * ROWS, stats_row);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg < n_active) {
      dkv_consumer<DH>(p, s, wg, k0, head, bi, n_qt);
    } else {   // every key of this warpgroup is >= lk_real: write zeros
      const int tid = threadIdx.x % WG;
      const int r0 = k0 + wg * ROWS + (tid / 32) * 16 + (tid % 32) / 4;
      float zero[DH / 2];
      zero_acc<DH>(zero);
      store_rows<DH>(p.dk, bi * p.dk_sb + head * DH, p.dk_sl, r0, p.lp,
                     p.lk_real, zero, 0.f, tid % 4, p.out_f32);
      store_rows<DH>(p.dv, bi * p.dv_sb + head * DH, p.dv_sl, r0, p.lp,
                     p.lk_real, zero, 0.f, tid % 4, p.out_f32);
    }
  }
}

template <typename Smem>
int set_smem(const void* kern) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<Smem>()));
}

template <int DH>
int launch(const BwdParams& p, int b, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    int e = set_smem<DqSmem<DH>>(
        reinterpret_cast<const void*>(flash_bwd_dq_kernel<DH>));
    if (e == 0)
      e = set_smem<DkvSmem<DH>>(
          reinterpret_cast<const void*>(flash_bwd_dkv_kernel<DH>));
    if (e != 0) return e;
    configured = true;
  }
  const dim3 grid((p.lp + BLOCK - 1) / BLOCK, p.h, b);
  flash_bwd_dq_kernel<DH>
      <<<grid, NTHREADS, smem_bytes<DqSmem<DH>>(), stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_kernel<DH>
      <<<grid, NTHREADS, smem_bytes<DkvSmem<DH>>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int prepare(BwdParams& p, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, int b,
            long long q_sb, long long q_sl, long long k_sb, long long k_sl,
            long long v_sb, long long v_sl, long long do_sb, long long do_sl) {
  const int width = p.h * DH;
  const bool ok =
      make_map_bf16<DH>(&p.tq, q, width, p.lq_real, b, q_sl, q_sb, ROWS) &&
      make_map_bf16<DH>(&p.tdo, dout, width, p.lq_real, b, do_sl, do_sb,
                        ROWS) &&
      make_map_bf16<DH>(&p.tk, k, width, p.lk_real, b, k_sl, k_sb, ROWS) &&
      make_map_bf16<DH>(&p.tv, v, width, p.lk_real, b, v_sl, v_sb, ROWS) &&
      make_map_f32(&p.tlse, lse, p.lq_real, p.pitch, b * p.h, ROWS) &&
      make_map_f32(&p.tdlt, delta, p.lq_real, p.pitch, b * p.h, ROWS);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch both kernels on `stream`; returns the first failing launch's
// cudaError_t (0 = success).  q is q~ = bf16(q * scale), formed by the
// caller; q/k/v/dout/dq/dk/dv: bf16 [b, lp, h*dh] views addressed by
// (batch, row) strides in elements, last dimension contiguous, base
// 16-byte aligned, q/k/v/dout strides multiples of 8 elements (TMA;
// checked by the Python wrapper).  lse and delta: f32 [b, h, pitch] with
// pitch = lp rounded up to a multiple of 4 (stats_pitch).  Rows >= lq_real
// of q / dout / lse / delta and rows >= lk_real of k / v are never read
// (1 <= lk_real, lq_real <= lp).  `scale` = dh^-1/2 * log2 e, the
// forward's.  dq/dk/dv are f32 (strides in f32 elements) when out_f32 != 0.
// dh in {16, 32, 64}.
extern "C" int odgs_flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int lp, int h, int dh, int lk_real, int lq_real, float scale,
    long long q_sb, long long q_sl, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, long long do_sb, long long do_sl,
    long long dq_sb, long long dq_sl, long long dk_sb, long long dk_sl,
    long long dv_sb, long long dv_sl, int out_f32, void* stream) {
  if (b == 0 || lp == 0 || h == 0) return 0;
  if (lk_real < 1 || lk_real > lp || lq_real < 1 || lq_real > lp)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.out_f32 = out_f32 != 0;
  p.lp = lp;
  p.h = h;
  p.lq_real = lq_real;
  p.lk_real = lk_real;
  p.pitch = stats_pitch(lp);
  p.dq_scale = scale * LN2;
  p.dq_sb = dq_sb; p.dq_sl = dq_sl; p.dk_sb = dk_sb; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sl = dv_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  switch (dh) {
    case 16:
      e = prepare<16>(p, q, k, v, dout, lse, delta, b, q_sb, q_sl, k_sb,
                      k_sl, v_sb, v_sl, do_sb, do_sl);
      return e != 0 ? e : launch<16>(p, b, s);
    case 32:
      e = prepare<32>(p, q, k, v, dout, lse, delta, b, q_sb, q_sl, k_sb,
                      k_sl, v_sb, v_sl, do_sb, do_sl);
      return e != 0 ? e : launch<32>(p, b, s);
    case 64:
      e = prepare<64>(p, q, k, v, dout, lse, delta, b, q_sb, q_sl, k_sb,
                      k_sl, v_sb, v_sl, do_sb, do_sl);
      return e != 0 ? e : launch<64>(p, b, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
