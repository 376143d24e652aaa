// Exact non-causal multi-head attention forward on the [b, l, h, d] layout.
//
// Replaces two TPU Pallas kernels:
//   * open_diffusiongs_tpu/ops/attention.py::flash_full_mha (:638-665;
//     _mha_padded :77-103, body _fwd_kernel :44-74), the DiT's general
//     attention route (qk_norm blocks, head widths that fail the packed
//     lane test, subset attention);
//   * tools/bench_attn2.py::mha_full (:89-126, body _fwd_kernel :43-86), the
//     bench tool's variant sweep, as the `SPLIT` / `SCORE_BF16` flags.
// Same math:
//   q/k/v bf16, element (b, row, head, c) at b*sb + row*sl + head*sh + c
//   (own strides per tensor, last dimension contiguous), any head width
//   d <= 64 (<= 128 for STATS), any number of heads; lq query rows, lk
//   keys (k/v may hold another number of rows than q: subset attention's
//   second half);
//   q~ = bf16(q * scale): `scale` is d^-1/2 * log2(e) already rounded to
//   bf16 by the wrapper, as #5 forms both in q's dtype (:652-654); the f32
//   product of two bf16 values is exact, so rounding it once is the bf16
//   product bit for bit; the bench variant passes a pre-scaled q and scale
//   1 (an exact no-op);
//   online softmax in base 2 with f32 running max and sum; keys >= lk never
//   contribute (TMA reads their K and V rows as 0, their scores are set to
//   -inf); the denominator is clamped at 1e-30 (:73); output bf16, a new
//   contiguous [b, lq, h, d].
// The TPU kernels find the row sum through a validity ones-column of V in
// the P·V matmul; here it is accumulated in registers over the same P that
// column sums: the unrounded f32 P of #5, the bf16 P of #6's bf16 variants.
//
// P·V in f32 (`SPLIT`: #5 always, :61-65; #6 with pv_f32).  wgmma's
// transpose bit exists only for 16-bit operands from shared memory, so a
// tf32 P·V would need V K-major: a transposed f32 copy of every V tile.
// Instead P is split into two bf16 terms on the same MN-major V tile:
// O += P_hi·V + P_lo·V, two bf16 wgmmas.  P_hi is P with its low 16 bits
// cleared (bf16 by truncation: one byte permute packs two), P_lo =
// bf16_rn(P - P_hi); P - P_hi is exact in f32 and < 2^-7 P, so
// |P - P_hi - P_lo| <= 2^-9 * 2^-7 P = 2^-16 P.  V is exact in bf16 and the
// products accumulate in f32, so P·V carries P to 2^-16 relative: finer
// than tf32's 2^-11 (the earlier mma.sync kernel) and 128x finer than the
// bf16 P of the packed kernel.  The truncated P_hi costs one permute per
// pair where a rounded one would cost a second conversion (the softmax, not
// the tensor cores, limits this kernel at d = 64).
// SCORE_BF16 (#6's score_bf16, bench_attn2 :55-63, :79-80): the scores,
// s - m, the exp2 and alpha are rounded to bf16 as the TPU does with a
// bf16 score dtype; P is then bf16-exact, so pv_f32 adds nothing and both
// score_bf16 variants run the one-product kernel.  The TPU's running max
// also sees #6's zeroed pad keys (their V and validity are zero, so only
// the max moves); here keys >= lk are excluded from it, the same function
// in exact arithmetic.  The TPU's `sub` switch (tile / bcast) is a
// lane-broadcast detail with identical results and has no counterpart.
//
// What bounds it: at the DiT's L = 4098, h = 16, d = 64 one call is
// 4·L²·d·h ≈ 68.8 GFLOP on ~25 MB of q/k/v, far above the H100's ridge:
// the function's f32 P·V at the tf32 rate (= two bf16 products) gives
// 0.104 ms, the exponentials (L²·h ≈ 2.7e8 on the SFUs) ≈ 0.07 ms.
//
// Design of #5 and #6 (flash_full_kernel): the packed forward's
// (flash_attn_fwd.cu), on csrc/hopper.cuh.  One block per (128-row q tile,
// head, batch) of three warpgroups.
//   * Producer (warpgroup 2, one thread; setmaxnreg 40): TMA loads of the
//     q tile once, then of 128-key K and V tiles into a ring of NSTAGE
//     stages, each with a full and an empty mbarrier.  Each tensor is a
//     4-D map {d, h, rows, b} with the caller's strides read in one-head
//     boxes [rows, DH]: DH in {16, 32, 64} (and 128 for STATS, below) is
//     the smallest tile >= d, and
//     TMA zero-fills the columns >= d (d 48 and 40 in a 64-wide tile, 20
//     in a 32-wide one) and the rows past lq / lk.  Zero columns add
//     nothing to q~·Kᵀ, and P·V's columns >= d are never stored.  Views TMA
//     cannot address (rows or heads not 16-byte aligned, d * 2 not a
//     multiple of 16) are copied by the wrapper into a zero-padded
//     contiguous [b, l, h, DH] buffer first (ops/attention.py::
//     full_takes_view, a rule on shapes and strides).
//   * Consumers (warpgroups 0 and 1, 64 q rows each; setmaxnreg 232):
//     q~ formed in registers from the q tile, the A operand of
//     S = q~·Kᵀ (wgmma m64n128k16, K as a K-major B); P converted in
//     registers from the f32 accumulator into bf16 A fragments of
//     O += P·V (wgmma m64n{DH}k16, V read MN-major through the transpose
//     bit: no transposed copy).
//   * Overlap, within each warpgroup: at key tile j it issues S_j and then
//     P_{j-1}·V_{j-1} as two commit groups, waits for S_j only and runs
//     tile j's mask, max and exp2 while P_{j-1}·V_{j-1} is on the tensor
//     cores; then it waits for that product, releases stage j-1 and
//     rescales O.  The two warpgroups also overlap each other.
//   * Epilogue: O / l in bf16 from registers, columns < d, rows < lq.
//
// STATS (#5s, odgs_flash_full_fwd_stats_bf16): the forward of the general
// route's TRAINING function, the primal of JAX's custom_vjp
// models/transformer.py::_flash_fwd_splash_bwd (_ffsb_fwd :141-146), which
// differentiates splash on `q_ * scale` (_splash_attention :75-113; splash
// itself is a JAX library kernel, so this kernel and flash_full_bwd.cu
// stand in for its forward and backward).  It differs from #5 in two
// roundings:
//   q~ = bf16(q * bf16(d^-1/2)) (splash's pre-scale: a bf16 array times a
//   weak-typed Python scale), NOT #5's bf16(q * bf16(d^-1/2 * log2 e)): at
//   d = 64 the two logit scales differ by 0.18 %.  The wrapper passes
//   scale = bf16(d^-1/2);
//   the softmax is natural-base: m is a running max of the f32 scores
//   s = q~.k, and P = 2^(s * log2 e - m * log2 e) (one FFMA a score).
// The same function is splash's forward at any head width, so it is also
// the splash route's serving forward (ops/attention.py::splash_mha, which
// drops the lse: `attn_impl: splash`, and heads wider than 64, which JAX
// sends to splash, transformer.py:159-166).  It takes d up to 128: DH = 128
// stores a tile row as two 128-byte swizzle spans, two [rows, 64] span
// tiles (csrc/hopper.cuh, span_of), each loaded by its own TMA box; q~.K^T
// walks the spans along K, and P.V runs one m64n64 product per span on its
// half of O.  It writes the base-2 log-sum-exp lse = m * log2 e + log2(l)
// of every row < lq, f32, into the backward's [b, h, pitch] layout (pitch =
// lq rounded up to a multiple of 4, ops/attention.py::stats_pitch), for
// flash_full_bwd.cu.  P.V is #5's split f32 product (P_hi + P_lo) and l
// sums the unrounded P, so o and lse are both the f32 function's; the
// backward rebuilds P from lse and rounds it to bf16 only as a wgmma
// operand.
//
// #5s's own kernel, flash_full_stats_kernel.  Per 128-key tile a consumer
// runs three products (q~.K^T, P_hi.V, P_lo.V) beside the softmax's FFMA,
// exp2, max and sum and the split's 3 operations a score; the tensor cores
// are the bound only if they never wait for a softmax.  What the card
// showed (chip_probe_bwd.py fwd-profile, fwd-variants): a wgmma with A in
// registers (P.V) holds its warps until it has run, so a warpgroup's
// softmax cannot hide its own P.V, only another warpgroup's products.  The
// design, by tile width (Sched):
//   * DH <= 64: three consumer warpgroups (192 q rows a tile), each running
//     a key tile in turn as S, softmax, split and P.V.  The other two keep
//     the tensor cores fed; setmaxnreg 160 (32 for the producer) fits S,
//     O and P_hi / P_lo because the first S product of a tile writes S
//     without reading it (Wgmma::ss_init), so S's registers are free while
//     P.V runs.  exp2 and the split run in one loop.
//   * DH = 128: two consumer warpgroups (128 q rows) that take turns to
//     issue (FA3's ping-pong, two named barriers BAR_TURN): consumer w
//     waits for its turn, issues S_j and P_{j-1}.V_{j-1} and passes the
//     turn on, so one consumer's softmax, rescale and split run under the
//     other's products; within a consumer, softmax j also runs while
//     P_{j-1}.V_{j-1} is on the tensor cores.  setmaxnreg 240 (24): S (64)
//     + O (64) + P_hi / P_lo (32 + 32) registers at 128 keys.
//   * q~ in shared memory: each consumer forms bf16(q * scale) from the q
//     tile once and writes it back in place; S is a wgmma with both
//     operands in shared memory (ss), so no q~ fragments stay in registers.
//   * A stale running max: a row's max moves only when a tile raises it by
//     more than RESCALE_TAU in base 2; otherwise P is taken against the
//     stale max (P <= 2^TAU) and O and l are not rescaled.  o = O / l and
//     lse = m * log2 e + log2(l) are the same function for any m; only the
//     roundings move.  A warp whose rows all keep their max skips the
//     rescale of O.
//   * exp2 as one SFU instruction (ex2.approx.ftz: results below 2^-126
//     flush to 0, far under P.V's 2^-16 and l >= 1).
//   * A persistent grid: one CTA an SM (the host's plan, ops/attention.py::
//     full_fwd_plan) walks the q tiles t = blockIdx.x, + gridDim.x, ... in
//     (q tile, head, batch) order; the producer loads the next tile's q
//     once every consumer has issued its last S (qempty) and keeps the K /
//     V ring running across tiles, so a tile's epilogue overlaps the next
//     one's loads.  Every consumer runs every tile (rows >= lq are computed
//     on TMA's zero rows and not stored), so the turn order never breaks.
// Smem: q 24 KB + 4 stages x (K + V) 32 KB at DH = 64; 32 KB + 3 x 64 KB at
// DH = 128.
// Tried and dropped (PERF.md, Findings): ping-pong at DH <= 64, three serial
// consumers at DH = 128 (64-key tiles), more or fewer stages, P_lo rounded
// on the integer pipe, a Veltkamp split, exp2 on the FMA pipe, the P.V issue
// interleaved with the softmax, a Cauchy-Schwarz bound in place of the
// tile's max.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace odgs;

constexpr int WG = 128;          // threads per warpgroup
constexpr int ROWS = 64;         // q rows per consumer warpgroup
constexpr int BQ = 2 * ROWS;     // q rows per block (a q tile)
constexpr int BK = 128;          // keys per stage (a key tile)
constexpr int NSTAGE = 3;
constexpr int NTHREADS = 3 * WG; // consumers 0 and 1, producer 2
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct FullSmem {   // span-stored tiles (hopper.cuh, span_of)
  alignas(1024) __nv_bfloat16 q[BQ * DH];
  alignas(1024) __nv_bfloat16 k[NSTAGE][BK * DH];
  alignas(1024) __nv_bfloat16 v[NSTAGE][BK * DH];
  uint64_t full[NSTAGE], empty[NSTAGE], qfull;
};

struct FullParams {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;     // contiguous [b, lq, h, d]
  float* lse;           // STATS: [b, h, pitch] f32
  int lq, lk, h, d, pitch;
  int n_qt, n_tiles;    // STATS: q tiles of a (batch, head), and in all
  float scale;          // bf16-representable
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Both values rounded to bf16 (round to nearest even) through one packing
// conversion: conversions run at a fraction of the FP32 rate, and the
// softmax, not the tensor cores, bounds the bf16-score variants.
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const uint32_t u = pack_bf16x2(a, b);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// P_hi (truncated) and P_lo = bf16_rn(P - P_hi) of a pair (see the header)
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);   // high halves
  lo = pack_bf16x2(a - __uint_as_float(ua & 0xffff0000u),
                   b - __uint_as_float(ub & 0xffff0000u));
}

// o = O * inv in bf16 at this thread's rows r0, r0 + 8 (those < lq) and
// columns 8 n + 2 t4 (+1) (those < d) of head `head` of batch element bi
// (the accumulator layout of hopper.cuh's Wgmma)
template <int DH>
__device__ __forceinline__ void store_o(const FullParams& p,
                                        const float (&oacc)[DH / 2],
                                        const float (&inv)[2], int r0,
                                        int head, int bi, int t4) {
  const long long pitch = (long long)p.h * p.d;   // o's row stride
  __nv_bfloat16* ob =
      p.o + (long long)bi * p.lq * pitch + (long long)head * p.d;
  const bool pairs = (p.d & 1) == 0;   // column pairs 4-byte aligned
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c >= p.d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= p.lq) continue;
      __nv_bfloat16* dst = ob + (long long)r * pitch + c;
      const float x0 = oacc[4 * n + 2 * half] * inv[half];
      const float x1 = oacc[4 * n + 2 * half + 1] * inv[half];
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (c + 1 < p.d) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DH, bool SPLIT, bool SCORE_BF16>
__device__ __forceinline__ void full_consumer(const FullParams& p,
                                              FullSmem<DH>& s, int wg,
                                              int q0, int head, int bi,
                                              int n_kt) {
  constexpr int KSTEPS = DH / 16;   // k16 steps of q~.K^T
  constexpr int PSTEPS = BK / 16;   // k16 steps of P.V
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rl = wg * ROWS + warp * 16 + g;   // rows rl and rl + 8 of the tile
  const int r0 = q0 + rl;

  // q~ A fragments: rows rl (+8), columns 16 kk + 2 t4 (+8); bf16(q*scale).
  mbar_wait(&s.qfull, 0);
  uint32_t qf[KSTEPS][4];
  load_a_frags_tile<DH>(s.q, BQ, rl, t4, qf);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]));
      qf[kk][i] = pack_bf16x2(f.x * p.scale, f.y * p.scale);
    }

  float sacc[BK / 2], oacc[DH / 2];
  uint32_t phi[PSTEPS][4], plo[PSTEPS][4];   // plo: SPLIT only
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<BK>::template rs<0>(sacc, qf[kk], kdesc_tile<DH>(s.k[st], BK, kk),
                                kk > 0);
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj) {
      mma_mn<DH>(oacc, phi[kj], s.v[st], BK, kj);
      if (SPLIT) mma_mn<DH>(oacc, plo[kj], s.v[st], BK, kj);
    }
  };
  // The bf16-P variant sums the rounded P, which exists only once to_p has
  // packed it; the others sum P in the softmax.
  constexpr bool SUM_AT_PACK = !SPLIT && !SCORE_BF16;
  // Masks, the new max, sacc <- P = 2^(s - m) and this thread's part of the
  // row sums over P; alpha rescales what was accumulated before tile j.
  auto softmax = [&](int j, float (&alpha)[2], float (&ls)[2]) {
    const int k0 = j * BK;
    if (SCORE_BF16) {
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) round_bf16x2(sacc[i], sacc[i + 1]);
    }
    if (k0 + BK > p.lk) {   // ragged last tile: keys >= lk drop out
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= p.lk) sacc[i] = -INFINITY;
    }
    float mt0 = m_run[0], mt1 = m_run[1];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mt0 = fmaxf(mt0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      mt1 = fmaxf(mt1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
    // Every processed tile holds >= 1 real key, so the new max is finite
    // and exp2f(-inf - m) = 0 on the first tile.
    if (SCORE_BF16) {
      alpha[0] = round_bf16(exp2f(round_bf16(m_run[0] - mt0)));
      alpha[1] = round_bf16(exp2f(round_bf16(m_run[1] - mt1)));
    } else {
      alpha[0] = exp2f(m_run[0] - mt0);
      alpha[1] = exp2f(m_run[1] - mt1);
    }
    m_run[0] = mt0;
    m_run[1] = mt1;
    ls[0] = ls[1] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {   // a pair shares its row
      const float m = (i & 2) ? mt1 : mt0;
      float e0 = sacc[i] - m, e1 = sacc[i + 1] - m;
      if (SCORE_BF16) round_bf16x2(e0, e1);
      e0 = exp2f(e0);
      e1 = exp2f(e1);
      if (SCORE_BF16) round_bf16x2(e0, e1);
      sacc[i] = e0;
      sacc[i + 1] = e1;
      if (!SUM_AT_PACK) ls[(i >> 1) & 1] += e0 + e1;
    }
  };
  // The accumulator of n8 tiles 2 kj, 2 kj + 1 is the A fragment of k16
  // step kj: P_hi (and P_lo) packed in pairs.  SUM_AT_PACK: adds the
  // rounded P to the row sums l.
  auto to_p = [&](float (&l)[2]) {
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // row g (+8 for odd i)
        const float a = sacc[8 * kj + 2 * i], b = sacc[8 * kj + 2 * i + 1];
        if (SPLIT) {
          split_p(a, b, phi[kj][i], plo[kj][i]);
        } else {
          const uint32_t u = pack_bf16x2(a, b);
          phi[kj][i] = u;
          if (SUM_AT_PACK)
            l[i & 1] += __uint_as_float(u << 16) +
                        __uint_as_float(u & 0xffff0000u);
        }
      }
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
  to_p(l_run);
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
    to_p(l_run);
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
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  store_o<DH>(p, oacc, inv, r0, head, bi, t4);
}

template <int DH, bool SPLIT, bool SCORE_BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_full_kernel(const __grid_constant__ FullParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  FullSmem<DH>& s = smem_storage<FullSmem<DH>>(smem_raw);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const int wg = threadIdx.x / WG;
  const int n_active = q0 + ROWS < p.lq ? 2 : 1;   // consumers with rows < lq
  const int n_kt = (p.lk + BK - 1) / BK;
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
      tma_load_heads<DH>(s.q, &p.tq, &s.qfull, head, q0, bi, BQ);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % NSTAGE;
        mbar_wait(&s.empty[st], ((j / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * BK * DH * 2);
        tma_load_heads<DH>(s.k[st], &p.tk, &s.full[st], head, j * BK, bi, BK);
        tma_load_heads<DH>(s.v[st], &p.tv, &s.full[st], head, j * BK, bi, BK);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg < n_active)
      full_consumer<DH, SPLIT, SCORE_BF16>(p, s, wg, q0, head, bi, n_kt);
  }
}

// ---------------------------------------------------------------------------
// #5s: flash_full_stats_kernel (see the header)
// ---------------------------------------------------------------------------

// #5s's schedule at a tile width (the header): three serial consumers at
// DH <= 64, two in ping-pong at DH = 128; a 128-key tile and a ring of as
// many stages as a block's shared memory holds.  setmaxnreg only moves the
// registers a CTA was launched with (the launch bound's LAUNCH_REGS a
// thread): what the consumers add, the producer must give up, or their
// setmaxnreg.inc waits forever.
template <int DH>
struct Sched {
  static constexpr bool PINGPONG = DH > 64;
  static constexpr int NC = PINGPONG ? 2 : 3;     // consumer warpgroups
  static constexpr int SQ = NC * ROWS;            // q rows of a tile
  static constexpr int NST = PINGPONG ? 3 : 4;    // K / V stages
  static constexpr int REGS = PINGPONG ? 240 : 160;
  static constexpr int PRODUCER_REGS = PINGPONG ? 24 : 32;
  static constexpr int THREADS = (NC + 1) * WG;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static_assert(NC * (REGS - LAUNCH_REGS) <= LAUNCH_REGS - PRODUCER_REGS,
                "the consumers take more registers than the producer frees");
};
constexpr float RESCALE_TAU = 8.f;  // base-2 rise of a row's max that moves it
constexpr int BAR_TURN = 1;         // 1 + w: consumer w's turn to issue
constexpr int BAR_Q = 3;            // 3 + w: consumer w's q~ written

template <int DH>
struct StatsSmem {   // span-stored tiles (hopper.cuh, span_of)
  using S = Sched<DH>;
  alignas(1024) __nv_bfloat16 q[S::SQ * DH];
  alignas(1024) __nv_bfloat16 k[S::NST][BK * DH];
  alignas(1024) __nv_bfloat16 v[S::NST][BK * DH];
  uint64_t full[S::NST], empty[S::NST], qfull, qempty;
};
static_assert(smem_bytes<StatsSmem<128>>() <= 232448 &&
                  smem_bytes<StatsSmem<64>>() <= 232448,
              "a block's shared memory: 227 KB");

// 2^x as one SFU instruction; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// q tile t of the persistent walk: (q tile, head, batch), q tile fastest.
template <int DH>
__device__ __forceinline__ void tile_at(const FullParams& p, int t, int& q0,
                                        int& head, int& bi) {
  q0 = (t % p.n_qt) * Sched<DH>::SQ;
  const int r = t / p.n_qt;
  head = r % p.h;
  bi = r / p.h;
}

// One thread: each tile's K / V ring and, behind its first key tile, its q
// tile once the consumers are done with the last one's q~.
template <int DH>
__device__ __forceinline__ void stats_producer(const FullParams& p,
                                               StatsSmem<DH>& s) {
  using S = Sched<DH>;
  const int n_kt = (p.lk + BK - 1) / BK;
  int it = 0, ti = 0;   // key tiles and q tiles loaded so far
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x, ++ti) {
    int q0, head, bi;
    tile_at<DH>(p, t, q0, head, bi);
    for (int j = 0; j < n_kt; ++j, ++it) {
      const int st = it % S::NST;
      mbar_wait(&s.empty[st], ((it / S::NST) & 1) ^ 1);
      mbar_expect_tx(&s.full[st], 2 * BK * DH * 2);
      tma_load_heads<DH>(s.k[st], &p.tk, &s.full[st], head, j * BK, bi, BK);
      tma_load_heads<DH>(s.v[st], &p.tv, &s.full[st], head, j * BK, bi, BK);
      if (j == 0) {
        mbar_wait(&s.qempty, (ti & 1) ^ 1);
        mbar_expect_tx(&s.qfull, S::SQ * DH * 2);
        tma_load_heads<DH>(s.q, &p.tq, &s.qfull, head, q0, bi, S::SQ);
      }
    }
  }
}

// The consumers' per-tile state and steps, shared by both schedules: rows
// rl and rl + 8 of a tile per thread (g = lane / 4, t4 = lane % 4).
template <int DH>
struct StatsRows {
  static constexpr int KSTEPS = DH / 16;   // k16 steps of q~.K^T
  static constexpr int PSTEPS = BK / 16;   // k16 steps of P.V
  float sacc[BK / 2], oacc[DH / 2];
  uint32_t phi[PSTEPS][4], plo[PSTEPS][4];
  float m_run[2], l_run[2];
  int tid, rl, t4;

  __device__ __forceinline__ StatsRows(int wg) {
    tid = threadIdx.x % WG;
    const int lane = tid % 32;
    rl = wg * ROWS + tid / 32 * 16 + lane / 4;
    t4 = lane % 4;
  }

  // q~ = bf16(q * scale) over this warpgroup's rows of the q tile, in
  // place (the A operand of S); O, m and l reset
  __device__ __forceinline__ void start(const FullParams& p,
                                        StatsSmem<DH>& s, int wg) {
    uint32_t qf[KSTEPS][4];
    load_a_frags_tile<DH>(s.q, Sched<DH>::SQ, rl, t4, qf);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]));
        qf[kk][i] = pack_bf16x2(f.x * p.scale, f.y * p.scale);
      }
    store_a_frags_tile<DH>(s.q, Sched<DH>::SQ, rl, t4, qf);
    fence_proxy_async();
    bar_sync(BAR_Q + wg, WG);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;
  }

  // S = q~.K^T, both operands in shared memory; the first product writes
  // S without reading it, so S's registers are free between key tiles
  __device__ __forceinline__ void issue_s(const __nv_bfloat16* qw,
                                          const __nv_bfloat16* k) {
    Wgmma<BK>::template ss_init<0>(sacc, kdesc_tile<DH>(qw, Sched<DH>::SQ, 0),
                                   kdesc_tile<DH>(k, BK, 0));
#pragma unroll
    for (int kk = 1; kk < KSTEPS; ++kk)
      Wgmma<BK>::template ss<0>(sacc, kdesc_tile<DH>(qw, Sched<DH>::SQ, kk),
                                kdesc_tile<DH>(k, BK, kk), 1);
  }
  __device__ __forceinline__ void issue_pv(const __nv_bfloat16* v) {
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj) {
      mma_mn<DH>(oacc, phi[kj], v, BK, kj);
      mma_mn<DH>(oacc, plo[kj], v, BK, kj);
    }
  }

  // Keys >= lk of a ragged last tile drop out; the running max moves only
  // when the tile raises it by more than RESCALE_TAU in base 2 (every tile
  // holds >= 1 real key, so the tile's max is finite, and the first tile
  // moves m from -inf: alpha = 0).  Returns whether a row's max moved;
  // alpha rescales what was accumulated before.
  __device__ __forceinline__ bool new_max(int j, int lk, float (&alpha)[2]) {
    const int k0 = j * BK;
    if (k0 + BK > lk) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= lk) sacc[i] = -INFINITY;
    }
    float mt0 = m_run[0], mt1 = m_run[1];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mt0 = fmaxf(mt0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      mt1 = fmaxf(mt1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
    const bool up0 = (mt0 - m_run[0]) * LOG2E > RESCALE_TAU;
    const bool up1 = (mt1 - m_run[1]) * LOG2E > RESCALE_TAU;
    alpha[0] = up0 ? ex2((m_run[0] - mt0) * LOG2E) : 1.f;
    alpha[1] = up1 ? ex2((m_run[1] - mt1) * LOG2E) : 1.f;
    if (up0) m_run[0] = mt0;
    if (up1) m_run[1] = mt1;
    return up0 || up1;
  }
  // O and l times alpha, skipped by a warp whose rows all kept their max
  __device__ __forceinline__ void rescale(bool moved,
                                          const float (&alpha)[2]) {
    l_run[0] *= alpha[0];
    l_run[1] *= alpha[1];
    if (__any_sync(FULL, moved)) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        oacc[4 * n] *= alpha[0];
        oacc[4 * n + 1] *= alpha[0];
        oacc[4 * n + 2] *= alpha[1];
        oacc[4 * n + 3] *= alpha[1];
      }
    }
  }
  // P = 2^(s log2 e - m log2 e) of pair (kj, i) of this thread's scores
  // (the accumulator of n8 tiles 2 kj, 2 kj + 1 is the A fragment of k16
  // step kj; row g, +8 for odd i)
  __device__ __forceinline__ float2 p_pair(int kj, int i) const {
    const float ms = m_run[i & 1] * LOG2E;
    return make_float2(ex2(fmaf(sacc[8 * kj + 2 * i], LOG2E, -ms)),
                       ex2(fmaf(sacc[8 * kj + 2 * i + 1], LOG2E, -ms)));
  }
  // P straight into the P_hi / P_lo fragments (one loop mixes the SFU's
  // exp2 with the split's integer work), the row sums into l
  __device__ __forceinline__ void exp_split() {
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 e = p_pair(kj, i);
        l_run[i & 1] += e.x + e.y;
        split_p(e.x, e.y, phi[kj][i], plo[kj][i]);
      }
  }
  // P into S's registers and this thread's part of the row sums (while the
  // last tile's P_hi / P_lo are still read by its P.V)
  __device__ __forceinline__ void exp_in_place(float (&ls)[2]) {
    ls[0] = ls[1] = 0.f;
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 e = p_pair(kj, i);
        sacc[8 * kj + 2 * i] = e.x;
        sacc[8 * kj + 2 * i + 1] = e.y;
        ls[i & 1] += e.x + e.y;
      }
  }
  __device__ __forceinline__ void split_in_place() {
#pragma unroll
    for (int kj = 0; kj < PSTEPS; ++kj)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_p(sacc[8 * kj + 2 * i], sacc[8 * kj + 2 * i + 1], phi[kj][i],
                plo[kj][i]);
  }

  // lse = m log2 e + log2(l) (rows < lq) and o = O / l; the row sums live
  // spread over the 4 threads of a quad, and l >= 1 (the row's max
  // contributes 2^(>= 0))
  __device__ __forceinline__ void store(const FullParams& p, int q0, int head,
                                        int bi) {
    float l0 = l_run[0], l1 = l_run[1];
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const int r0 = q0 + rl;
    if (t4 == 0) {
      float* lrow = p.lse + (long long)(bi * p.h + head) * p.pitch;
      if (r0 < p.lq) lrow[r0] = m_run[0] * LOG2E + log2f(l0);
      if (r0 + 8 < p.lq) lrow[r0 + 8] = m_run[1] * LOG2E + log2f(l1);
    }
    const float inv[2] = {1.f / l0, 1.f / l1};
    store_o<DH>(p, oacc, inv, r0, head, bi, t4);
  }
};

// DH <= 64: three consumers, each running a key tile in turn as S,
// softmax, split and P.V, every product waited for before the next step.
// The other two consumers' products keep the tensor cores busy meanwhile:
// a product with A in registers holds its warps until it has run, so a
// consumer's own products never overlap its softmax.
template <int DH>
__device__ __forceinline__ void serial_consumer(const FullParams& p,
                                                StatsSmem<DH>& s, int wg) {
  using S = Sched<DH>;
  StatsRows<DH> r(wg);
  const int n_kt = (p.lk + BK - 1) / BK;
  const __nv_bfloat16* qw = s.q + wg * ROWS * span_of<DH>();   // its q~
  int it = 0, ti = 0;   // key tiles and q tiles consumed so far
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x, ++ti) {
    int q0, head, bi;
    tile_at<DH>(p, t, q0, head, bi);
    mbar_wait(&s.qfull, ti & 1);
    r.start(p, s, wg);
    for (int j = 0; j < n_kt; ++j, ++it) {
      const int st = it % S::NST;
      mbar_wait(&s.full[st], (it / S::NST) & 1);
      wgmma_fence();
      r.issue_s(qw, s.k[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(r.sacc);
      if (j == n_kt - 1 && r.tid == 0) mbar_arrive(&s.qempty);   // q~ read
      float alpha[2];
      const bool moved = r.new_max(j, p.lk, alpha);
      r.rescale(moved, alpha);
      r.exp_split();
      wgmma_fence();
      r.issue_pv(s.v[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(r.oacc);
      if (r.tid == 0) mbar_arrive(&s.empty[st]);
    }
    r.store(p, q0, head, bi);
  }
}

// DH = 128: two consumers that take turns to issue (FA3's ping-pong),
// ordered by two named barriers: consumer w waits for its turn, issues
// S_j and P_{j-1}.V_{j-1} and passes the turn on, so one consumer's
// softmax, rescale and split run under the other's products; S_j's
// softmax also runs while P_{j-1}.V_{j-1} is on the tensor cores.  Every
// turn taken is passed: consumer 1 starts by passing the first turn to 0,
// and its very last pass has no taker.
template <int DH>
__device__ __forceinline__ void pingpong_consumer(const FullParams& p,
                                                  StatsSmem<DH>& s, int wg) {
  using S = Sched<DH>;
  StatsRows<DH> r(wg);
  const int n_kt = (p.lk + BK - 1) / BK;
  const __nv_bfloat16* qw = s.q + wg * ROWS * span_of<DH>();   // its q~
  auto take_turn = [&] { bar_sync(BAR_TURN + wg, 2 * WG); };
  auto pass_turn = [&] { bar_arrive(BAR_TURN + (wg ^ 1), 2 * WG); };
  if (wg == 1) pass_turn();   // consumer 0 issues first
  int it = 0, ti = 0;         // key tiles and q tiles consumed so far
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x, ++ti) {
    int q0, head, bi;
    tile_at<DH>(p, t, q0, head, bi);
    mbar_wait(&s.qfull, ti & 1);
    r.start(p, s, wg);
    float alpha[2], ls[2];
    mbar_wait(&s.full[it % S::NST], (it / S::NST) & 1);
    take_turn();
    wgmma_fence();
    r.issue_s(qw, s.k[it % S::NST]);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(r.sacc);
    if (n_kt == 1 && r.tid == 0) mbar_arrive(&s.qempty);   // q~ read
    r.new_max(0, p.lk, alpha);
    r.exp_in_place(ls);
    r.l_run[0] = ls[0];
    r.l_run[1] = ls[1];
    r.split_in_place();
    for (int j = 1; j < n_kt; ++j) {
      const int c = it + j, st = c % S::NST, prev = (c - 1) % S::NST;
      mbar_wait(&s.full[st], (c / S::NST) & 1);
      take_turn();
      wgmma_fence();
      r.issue_s(qw, s.k[st]);
      wgmma_commit();
      r.issue_pv(s.v[prev]);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();        // S_j is done; P_{j-1}.V_{j-1} may still run
      fence_regs(r.sacc);
      if (j == n_kt - 1 && r.tid == 0) mbar_arrive(&s.qempty);   // q~ read
      const bool moved = r.new_max(j, p.lk, alpha);
      r.exp_in_place(ls);
      wgmma_wait<0>();
      fence_regs(r.oacc);
      if (r.tid == 0) mbar_arrive(&s.empty[prev]);
      r.rescale(moved, alpha);
      r.l_run[0] += ls[0];
      r.l_run[1] += ls[1];
      r.split_in_place();
    }
    const int last = (it + n_kt - 1) % S::NST;
    take_turn();
    wgmma_fence();
    r.issue_pv(s.v[last]);
    wgmma_commit();
    if (wg == 0 || t + (int)gridDim.x < p.n_tiles) pass_turn();
    wgmma_wait<0>();
    fence_regs(r.oacc);
    if (r.tid == 0) mbar_arrive(&s.empty[last]);
    it += n_kt;
    r.store(p, q0, head, bi);
  }
}

template <int DH>
__global__ void __launch_bounds__(Sched<DH>::THREADS, 1)
flash_full_stats_kernel(const __grid_constant__ FullParams p) {
  using S = Sched<DH>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  StatsSmem<DH>& s = smem_storage<StatsSmem<DH>>(smem_raw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S::NST; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], S::NC);
    }
    mbar_init(&s.qfull, 1);
    mbar_init(&s.qempty, S::NC);
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == S::NC) {
    setmaxnreg_dec<S::PRODUCER_REGS>();
    if (threadIdx.x == S::NC * WG) stats_producer<DH>(p, s);
  } else {
    setmaxnreg_inc<S::REGS>();
    if constexpr (S::PINGPONG)
      pingpong_consumer<DH>(p, s, wg);
    else
      serial_consumer<DH>(p, s, wg);
  }
}

// The tensor maps and scalars of one launch (either kernel).
// q tiles of q_rows rows and k / v tiles of k_rows rows.
template <int DH>
bool full_params(FullParams& p, const void* q, const void* k, const void* v,
                 void* o, int b, int lq, int lk, int h, int d, int dm,
                 float scale, long long q_sb, long long q_sl, long long q_sh,
                 long long k_sb, long long k_sl, long long k_sh,
                 long long v_sb, long long v_sl, long long v_sh, int q_rows,
                 int k_rows) {
  if (!make_map_heads_bf16<DH>(&p.tq, q, dm, h, lq, b, q_sh, q_sl, q_sb,
                               q_rows) ||
      !make_map_heads_bf16<DH>(&p.tk, k, dm, h, lk, b, k_sh, k_sl, k_sb,
                               k_rows) ||
      !make_map_heads_bf16<DH>(&p.tv, v, dm, h, lk, b, v_sh, v_sl, v_sb,
                               k_rows))
    return false;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = nullptr;
  p.lq = lq;
  p.lk = lk;
  p.h = h;
  p.d = d;
  p.pitch = (lq + 3) / 4 * 4;
  p.n_qt = (lq + q_rows - 1) / q_rows;
  p.n_tiles = p.n_qt * h * b;
  p.scale = scale;
  return true;
}

template <typename K>
cudaError_t allow_smem(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int DH, bool SPLIT, bool SCORE_BF16>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int lq, int lk, int h, int d, int dm, float scale, long long q_sb,
           long long q_sl, long long q_sh, long long k_sb, long long k_sl,
           long long k_sh, long long v_sb, long long v_sl, long long v_sh,
           cudaStream_t stream) {
  FullParams p;
  if (!full_params<DH>(p, q, k, v, o, b, lq, lk, h, d, dm, scale, q_sb, q_sl,
                       q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, BQ, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_full_kernel<DH, SPLIT, SCORE_BF16>;
  constexpr int smem = smem_bytes<FullSmem<DH>>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.n_qt, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_stats(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int lq, int lk, int h, int d, int dm,
                 float scale, long long q_sb, long long q_sl, long long q_sh,
                 long long k_sb, long long k_sl, long long k_sh,
                 long long v_sb, long long v_sl, long long v_sh, int grid,
                 cudaStream_t stream) {
  FullParams p;
  if (!full_params<DH>(p, q, k, v, o, b, lq, lk, h, d, dm, scale, q_sb, q_sl,
                       q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                       Sched<DH>::SQ, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<float*>(lse);
  auto kern = flash_full_stats_kernel<DH>;
  constexpr int smem = smem_bytes<StatsSmem<DH>>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int ctas = grid < p.n_tiles ? grid : p.n_tiles;
  kern<<<ctas, Sched<DH>::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).
// q [b, lq, h, *] and k/v [b, lk, h, *] bf16 read through (batch, row,
// head) strides in elements, last dimension contiguous; the maps read
// `dm` columns (d <= dm <= the tile width 16 / 32 / 64 that d rounds up
// to; dm > d for the wrapper's zero-padded copies), the output o is a
// contiguous [b, lq, h, d] bf16 tensor.  TMA's rule: 16-byte aligned
// bases, dm * 2 and the strides of dimensions longer than 1 multiples of
// 16 bytes (ops/attention.py::full_takes_view).  pv_f32 = 1, score_bf16
// = 0 is flash_full_mha, for any d in 1..64; the other three flag pairs
// are the bench variants and take d = dm = 64.
extern "C" int odgs_flash_full_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int lq,
    int lk, int h, int d, int dm, float scale, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, int pv_f32,
    int score_bf16, void* stream) {
  if (b == 0 || lq == 0 || h == 0) return 0;
  const int tile = d <= 16 ? 16 : d <= 32 ? 32 : 64;
  if (lk < 1 || d < 1 || d > 64 || dm < d || dm > tile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ODGS_FULL_ARGS                                                      \
  q, k, v, o, b, lq, lk, h, d, dm, scale, q_sb, q_sl, q_sh, k_sb, k_sl,     \
      k_sh, v_sb, v_sl, v_sh, s
  if (pv_f32 && !score_bf16) {
    if (tile == 16) return launch<16, true, false>(ODGS_FULL_ARGS);
    if (tile == 32) return launch<32, true, false>(ODGS_FULL_ARGS);
    return launch<64, true, false>(ODGS_FULL_ARGS);
  }
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (score_bf16) return launch<64, false, true>(ODGS_FULL_ARGS);
  return launch<64, false, false>(ODGS_FULL_ARGS);
#undef ODGS_FULL_ARGS
}

// #5s (see the header): scale = bf16(d^-1/2), lse an f32 [b, h, pitch]
// buffer (pitch = lq rounded up to a multiple of 4) whose columns < lq are
// written, and `grid` CTAs (at most one a q tile; the host's plan gives one
// an SM) walking the q tiles.  Any d in 1..128 (tiles 16 / 32 / 64 / 128).
extern "C" int odgs_flash_full_fwd_stats_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int lq, int lk, int h, int d, int dm, float scale, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, int grid,
    void* stream) {
  if (b == 0 || lq == 0 || h == 0) return 0;
  const int tile = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (lk < 1 || d < 1 || d > 128 || dm < d || dm > tile || lse == nullptr ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ODGS_FULL_ARGS                                                      \
  q, k, v, o, lse, b, lq, lk, h, d, dm, scale, q_sb, q_sl, q_sh, k_sb,      \
      k_sl, k_sh, v_sb, v_sl, v_sh, grid, s
  if (tile == 16) return launch_stats<16>(ODGS_FULL_ARGS);
  if (tile == 32) return launch_stats<32>(ODGS_FULL_ARGS);
  if (tile == 64) return launch_stats<64>(ODGS_FULL_ARGS);
  return launch_stats<128>(ODGS_FULL_ARGS);
#undef ODGS_FULL_ARGS
}
