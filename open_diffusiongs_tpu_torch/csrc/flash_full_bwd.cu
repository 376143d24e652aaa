// Exact multi-head attention backward on the [b, l, h, d] layout (#5b).
//
// The backward of the general route's training function, whose forward is
// flash_full_fwd.cu's STATS flag (#5s).  It has no Pallas counterpart: JAX
// differentiates that route through splash (open_diffusiongs_tpu/models/
// transformer.py::_flash_fwd_splash_bwd :116-152, the custom_vjp whose
// forward and backward rules are splash on `q * d^-1/2`, _ffsb_fwd
// :141-146), a JAX library kernel; this file takes the place of splash's
// backward.  Same algebra, natural-base scores in the exp2 domain:
//   q~ = bf16(q * bf16(d^-1/2))             (the prep launch, below)
//   P  = exp2(log2 e * (q~ . k) - lse)      (lse: #5s's base-2 lse)
//   dP = dO . v,  dS = P * (dP - delta)     (delta = rowsum(dO * O), prep)
//   dq = bf16(d^-1/2) * dS . K,  dk = dS^T . q~,  dv = P^T . dO
// f32 accumulation; P and dS are rounded to bf16 as the tensor cores'
// operands.  q/dO hold lq rows, k/v lk rows (lk may differ: the second half
// of subset attention).  Keys >= lk and query rows >= lq contribute nothing
// (TMA reads their rows as 0, P forced to 0); no output row past lq / lk is
// written.  Any head width d <= 128 at the tiles DH = 16, 32, 64, 128: TMA
// zero-fills the columns >= d, which add nothing, and the columns >= d of
// dq / dk / dv are never stored.
//
// What bounds it: at b = 4, L = 4098, h = 16, d = 64 the function needs 5
// products of 2 L^2 d per head (S, dP, dV, dK, dQ: 0.69 TFLOP, 0.70 ms at
// 989 TFLOP/s bf16) beside ~5.4e8 exp2; the bytes (~50 MB) take ~0.02 ms.
// This file runs exactly those 5 products, at every tile.  In practice the
// main pass is bound by shared memory: a consumer thread's registers hold
// dK, dV, S^T, dP^T and dQ^T, so most products read both operands from
// shared memory (wgmma ss), at N <= 64 as fast as shared memory feeds them
// (PERF.md §6).
//
// Three launches:
//   * flash_full_bwd_prep_kernel (one warp a query row and head): reads q,
//     O and dO once, writes q~ (bit for bit the plain bf16(f32(q) *
//     f32(bf16(d^-1/2)))), delta into the [b*h, pitch] f32 layout of the
//     lse, and zeroes the main pass's counters;
//   * flash_full_bwd_kernel: ONE pass over key blocks.  A CTA owns one
//     block of 128 keys of one (batch, head) at a time: K and V resident,
//     dK and dV in registers; it streams q~, dO, lse and delta tiles of QS
//     query rows (QS = 64; 32 at DH = 128) through a TMA ring and forms S^T,
//     P^T, dP^T and dS^T once per tile.  From the same dS^T it computes the
//     tile's dQ partial, so the products are S^T = K.q~^T, dP^T = V.dO^T,
//     dV += P^T.dO, dK += dS^T.q~ and dQ^T = K^T.dS^T: five;
//   * flash_full_bwd_epilogue_kernel: dq = bf16(dq_scale * acc).
// Warp roles: two consumer warpgroups of 64 keys each (setmaxnreg 224), a
// producer warpgroup (setmaxnreg 56) whose thread 0 issues the TMA loads and
// whose warps 1-3 are the dQ writers.  Operands come from wgmma's
// transpose bits: S^T / dP^T take K and V as register fragments at
// DH <= 64 (loaded once a head) and from shared memory at DH = 128, q~ and
// dO K-major.  P^T and dS^T go to shared memory (bf16, 32-query SW64
// tiles, two slots): P^T feeds dV and dS^T feeds dK as K-major A operands
// (dO and q~ MN-major), and dS^T feeds dQ^T as an MN-major B with K as an
// MN-major A.  Each consumer computes 64 rows of dQ^T: at DH <= 64 all of
// d (K kept 64 columns wide, zero past d) for its 32 of the step's 64
// queries, at DH = 128 its 64-column span of d for all 32 queries.  So the
// accumulators of a consumer thread are dK + dV (DH), S^T + dP^T (QS) and
// dQ^T (16): 144 registers at DH = 64 (plus 32 of K / V fragments), 176 at
// DH = 128.  At DH <= 64 tile j+1's score products are issued before tile
// j's three gradient products, and the exp2 work of j+1 runs while those
// are on the tensor cores; at DH = 128 they follow them (the two
// accumulator sets together would spill).  Tile j's dQ^T goes to the stage
// after they finish.  Every wgmma loop is unrolled and no wgmma is issued
// or waited for under a runtime condition: either makes ptxas serialise
// them (C7514).
//
// Deterministic dQ.  The partials go through shared memory (a three-slot
// f32 stage) to the writers, which add them into an f32 accumulator of dQ
// tiles in global memory (scratch, [b*h, n_qt, QS, DH]) with plain loads
// and stores: no float is ever added by an atomic.  Three writer warps
// take every third tile each, so three hand-offs are in flight.  Every
// query tile takes its key blocks' partials in one fixed order, key block
// 0, 1, ..., n_kb-1, behind a counter per (batch, head, query tile): the
// writer of key block kb waits (ld.acquire) until the counter reads kb,
// adds acc + partial, and releases kb + 1 (st.release after a fence).  Key
// block 0 stores its partial without reading; the epilogue launch rounds
// the final sums to dq (writing bf16 from the chain's last key block made
// its CTA the slowest of the grid: the kernel ends with it).  So every dq
// element is the same sum in the same order in every launch, whatever
// order the CTAs run in.  The wait costs no wavefront: each CTA keeps its
// key block for a run of heads, so after the first tiles the blocks run
// staggered by one hand-off each, and block kb finds block kb - 1's
// partial in place when its own is ready.
// No deadlock: the grid is `groups` x n_kb CTAs (groups = SMs / n_kb, at
// least 1: persistent), and a CTA takes its slot (group, key block) from a
// ticket counter as it starts, so slot s - 1, the only one slot s waits
// on, belongs to a CTA that has already started: it runs or has finished,
// also while other work holds some SMs.  Integer atomics order the work
// (the ticket); a wait that outlasts 10 s traps instead of hanging.
// Outputs: dq [b, lq, h, d] and dk / dv [b, lk, h, d], contiguous bf16.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace odgs;

constexpr int WG = 128;             // threads per warpgroup
constexpr int KEYS = 64;            // keys per consumer warpgroup
constexpr int BLOCK = 2 * KEYS;     // keys per CTA: one key block
constexpr int NTHREADS = 3 * WG;    // consumers 0 and 1, producer 2
constexpr int BAR_DS = 1;           // named barrier (0 is __syncthreads)
constexpr int NWRITER = 3;          // dQ writer warps = stage slots
constexpr int PREP_ROWS = 8;        // query rows (one warp each) a prep block
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint64_t WAIT_LIMIT_NS = 10000000000ull;   // 10 s: a fault

template <int DH>
struct Tile {
  static constexpr int QS = DH > 64 ? 32 : 64;   // query rows a step
  static constexpr int KW = DH < 64 ? 64 : DH;   // K's width in shared memory
  static constexpr int NDS = QS / 32;            // P^T / dS^T tiles of 32 q
  static constexpr int SPITCH = DH + 4;          // stage row pitch (f32)
  static constexpr int NV = QS * DH / 4;         // float4 in a dQ tile
  static constexpr int NSTAGE = 3;               // q~ / dO / lse / delta ring
};

struct BwdParams {
  CUtensorMap tq, tdo;           // q~ / dO, boxes [QS, DH]
  CUtensorMap tk, tv;            // k [KEYS, KW], v [KEYS, DH]
  CUtensorMap tlse, tdlt;        // boxes of [1, QS], columns < lq
  float* acc;                    // dQ tiles [b*h, n_qt, QS, DH] f32
  unsigned* cnt;                 // [b*h * n_qt] hand-offs, then the ticket
  __nv_bfloat16 *dk, *dv;        // contiguous [b, lk, h, d]
  int lq, lk, h, d, bh, n_qt, n_kb, groups;
};

template <int DH>
struct BwdSmem {
  using T = Tile<DH>;
  static constexpr int NSTAGE = T::NSTAGE;
  alignas(1024) __nv_bfloat16 k[2][KEYS * T::KW];      // resident, per WG
  alignas(1024) __nv_bfloat16 v[2][KEYS * DH];
  alignas(1024) __nv_bfloat16 q[NSTAGE][T::QS * DH];   // q~
  alignas(1024) __nv_bfloat16 d[NSTAGE][T::QS * DH];   // dO
  alignas(1024) __nv_bfloat16 ps[2][T::NDS][BLOCK * 32];   // P^T
  alignas(1024) __nv_bfloat16 ds[2][T::NDS][BLOCK * 32];   // dS^T
  alignas(128) float lse[NSTAGE][T::QS];
  alignas(128) float dlt[NSTAGE][T::QS];
  alignas(16) float stage[NWRITER][T::QS * T::SPITCH];  // dQ partials
  uint64_t full[NSTAGE], empty[NSTAGE], res_full, res_empty;
  uint64_t st_full[NWRITER], st_empty[NWRITER];
  unsigned slot;
};

struct PrepParams {
  const __nv_bfloat16 *q, *o, *dout;
  __nv_bfloat16* qs;             // q~ [b, lq, h, dm], zero past d
  float* delta;                  // [b*h, pitch]
  unsigned* cnt;                 // zeroed: n_cnt entries
  long long q_sb, q_sl, q_sh, o_sb, o_sl, o_sh, do_sb, do_sl, do_sh;
  int b, lq, h, d, dm, pitch, n_cnt;
  float scale;                   // bf16(d^-1/2)
};

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// mbar_wait that traps after WAIT_LIMIT_NS instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// Until *p == v (acquire); traps after WAIT_LIMIT_NS.
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned v) {
  if (ld_acquire(p) == v) return;
  const uint64_t t0 = now_ns();
  while (ld_acquire(p) != v)
    if (now_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// The ticket: an integer fetch-and-add (it orders CTAs, adds no data).
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.relaxed.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(t) : "memory");
  return old;
}

// Write this thread's rows row0, row0 + 8 (those < rows) and columns < d
// of a [64, DH] accumulator, scaled, into head `head` of batch element bi
// of a contiguous [b, rows, h, d] tensor.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int bi,
                                           int head, int rows, int h, int d,
                                           int row0,
                                           const float (&acc)[DH / 2],
                                           float scale, int t4) {
  const bool pairs = (d & 1) == 0;   // column pairs 4-byte aligned
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t4;
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

// The wgmma A fragments of k16 steps 0 .. N-1 of this warp's rows row0,
// row0 + 8 of a swizzled single-span [rows, W] bf16 tile (load_a_frags of
// its first N steps).
template <int W, int N>
__device__ __forceinline__ void load_a_steps(const __nv_bfloat16* tile,
                                            int row0, int t4,
                                            uint32_t (&f)[N][4]) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(tile);
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1), col = kk * 16 + 2 * t4 + 8 * (i >> 1);
      f[kk][i] = *reinterpret_cast<const uint32_t*>(
          base + swz<W>(row * W * 2 + col * 2));
    }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// ---------------------------------------------------------------------------
// The prep launch: q~, delta, and the main pass's counters zeroed.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PREP_ROWS * 32)
flash_full_bwd_prep_kernel(const __grid_constant__ PrepParams p) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gt < p.n_cnt) p.cnt[gt] = 0u;
  const long long row = (long long)blockIdx.x * PREP_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.b * p.lq * p.h) return;
  const int head = (int)(row % p.h);
  const int r = (int)((row / p.h) % p.lq), bi = (int)(row / p.h / p.lq);
  const __nv_bfloat16* q = p.q + bi * p.q_sb + r * p.q_sl + head * p.q_sh;
  const __nv_bfloat16* o = p.o + bi * p.o_sb + r * p.o_sl + head * p.o_sh;
  const __nv_bfloat16* dout =
      p.dout + bi * p.do_sb + r * p.do_sl + head * p.do_sh;
  __nv_bfloat16* qs = p.qs + row * p.dm;   // row = (bi * lq + r) * h + head
  float delta = 0.f;
  for (int c = lane; c < p.dm; c += 32) {
    float x = 0.f;
    if (c < p.d) {
      x = __bfloat162float(q[c]) * p.scale;   // exact in f32, rounded once
      delta = fmaf(__bfloat162float(dout[c]), __bfloat162float(o[c]), delta);
    }
    qs[c] = __float2bfloat16_rn(x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    delta += __shfl_xor_sync(0xffffffffu, delta, off);
  if (lane == 0) p.delta[((long long)bi * p.h + head) * p.pitch + r] = delta;
}

// The epilogue launch: dq = bf16(dq_scale * acc) on the rows < lq and the
// columns < d, one thread a column pair (or a column for an odd d).
struct EpiParams {
  const float* acc;              // [b*h, n_qt * QS, DH]
  __nv_bfloat16* dq;             // [b, lq, h, d]
  int b, lq, h, d, dh, rows;     // rows = n_qt * QS
  float scale;
};

__global__ void __launch_bounds__(256)
flash_full_bwd_epilogue_kernel(const __grid_constant__ EpiParams p) {
  const int per = (p.d & 1) == 0 ? 2 : 1;   // columns a thread
  const int cols = p.d / per;
  const long long n = (long long)p.b * p.lq * p.h * cols;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % cols) * per;
    const long long row = e / cols;   // (bi * lq + r) * h + head
    const int head = (int)(row % p.h);
    const int r = (int)((row / p.h) % p.lq), bi = (int)(row / p.h / p.lq);
    const float* a =
        p.acc + (((long long)bi * p.h + head) * p.rows + r) * p.dh + c;
    __nv_bfloat16* dst = p.dq + row * p.d + c;
    if (per == 2)
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16x2(a[0] * p.scale, a[1] * p.scale);
    else
      dst[0] = __float2bfloat16_rn(a[0] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// The main pass: warp roles.
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void producer(const BwdParams& p, BwdSmem<DH>& s,
                                         int g, int kb) {
  using T = Tile<DH>;
  constexpr int NSTAGE = T::NSTAGE;
  int tt = 0;   // tiles streamed so far
  for (int it = 0, bh = g; bh < p.bh; ++it, bh += p.groups) {
    const int bi = bh / p.h, head = bh % p.h;
    if (it > 0) mbar_wait_bounded(&s.res_empty, (it - 1) & 1);
    mbar_expect_tx(&s.res_full, 2 * KEYS * (T::KW + DH) * 2);
    for (int w = 0; w < 2; ++w) {
      const int row = kb * BLOCK + w * KEYS;
      tma_load_heads<T::KW>(s.k[w], &p.tk, &s.res_full, head, row, bi, KEYS);
      tma_load_heads<DH>(s.v[w], &p.tv, &s.res_full, head, row, bi, KEYS);
    }
    for (int m = 0; m < p.n_qt; ++m, ++tt) {
      const int st = tt % NSTAGE;
      mbar_wait_bounded(&s.empty[st], ((tt / NSTAGE) & 1) ^ 1);
      mbar_expect_tx(&s.full[st], 2 * T::QS * DH * 2 + 2 * T::QS * 4);
      tma_load_heads<DH>(s.q[st], &p.tq, &s.full[st], head, m * T::QS, bi,
                         T::QS);
      tma_load_heads<DH>(s.d[st], &p.tdo, &s.full[st], head, m * T::QS, bi,
                         T::QS);
      tma_load_2d(s.lse[st], &p.tlse, &s.full[st], m * T::QS, bh);
      tma_load_2d(s.dlt[st], &p.tdlt, &s.full[st], m * T::QS, bh);
    }
  }
}

// The dQ writers: producer warps 1-3, each taking every third query tile
// (its stage slot), so that three hand-offs are in flight; the ordered
// hand-off described in the header.  Every lane acquires the counter
// itself, reads the accumulator tile in chunks of CHUNK float4 (L2 only:
// another SM wrote it), adds acc + partial and stores; then each lane
// fences and lane 0 releases the next key block.  The last key block
// stores too: the epilogue launch rounds the sums to dq.
template <int DH>
__device__ __forceinline__ void writer(const BwdParams& p, BwdSmem<DH>& s,
                                       int g, int kb, int wi) {
  using T = Tile<DH>;
  constexpr int C4 = DH / 4, CHUNK = 4;
  const int lane = threadIdx.x % 32;
  const bool first = kb == 0, last = kb == p.n_kb - 1;
  int tw = 0;   // tiles handed off so far, by all writers
  for (int bh = g; bh < p.bh; bh += p.groups) {
    for (int m = 0; m < p.n_qt; ++m, ++tw) {
      if (tw % NWRITER != wi) continue;
      const long long tile = (long long)bh * p.n_qt + m;
      float4* acc = reinterpret_cast<float4*>(p.acc + tile * T::QS * DH);
      const float* st = s.stage[wi];
      mbar_wait_bounded(&s.st_full[wi], (tw / NWRITER) & 1);
      if (!first) wait_count(p.cnt + tile, (unsigned)kb);
#pragma unroll 1
      for (int i0 = lane; i0 < T::NV; i0 += 32 * CHUNK) {
        float4 a[CHUNK];
        if (!first) {
#pragma unroll
          for (int u = 0; u < CHUNK; ++u)
            if (i0 + 32 * u < T::NV) a[u] = __ldcg(acc + i0 + 32 * u);
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          const int i = i0 + 32 * u;
          if (i >= T::NV) continue;
          const int r = i / C4, c = (i % C4) * 4;
          float4 x = *reinterpret_cast<const float4*>(st + r * T::SPITCH + c);
          if (!first) {   // acc + partial, in key-block order
            x.x = a[u].x + x.x;
            x.y = a[u].y + x.y;
            x.z = a[u].z + x.z;
            x.w = a[u].w + x.w;
          }
          __stcg(acc + i, x);
        }
      }
      if (!last) __threadfence();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&s.st_empty[wi]);
        if (!last) st_release(p.cnt + tile, (unsigned)kb + 1u);
      }
    }
  }
}

template <int DH>
__device__ __forceinline__ void consumer(const BwdParams& p, BwdSmem<DH>& s,
                                         int w, int g, int kb) {
  using T = Tile<DH>;
  constexpr int QS = T::QS, KW = T::KW, KSTEPS = DH / 16, QSTEPS = QS / 16;
  constexpr int NSTAGE = T::NSTAGE;
  constexpr bool OVERLAP = DH <= 64;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int kr = w * KEYS + warp * 16 + gq;   // key rows kr, kr + 8 of the block
  const int r0 = kb * BLOCK + kr;
  const bool real_k[2] = {r0 < p.lk, r0 + 8 < p.lk};
  // this warpgroup's dQ^T: 64 rows of d from d0, 32 queries from q0w
  const int d0 = DH > 64 ? 64 * w : 0, q0w = DH > 64 ? 0 : 32 * w;
  const int a_span = DH > 64 ? w : 0, b_tile = DH > 64 ? 0 : w;
  float dk[DH / 2], dv[DH / 2], sacc[QS / 2], pacc[QS / 2], dqt[16];
  // At DH <= 64 the score products take K and V from registers (A
  // fragments loaded once a head): half their shared-memory reads
  constexpr bool A_REG = DH <= 64;
  uint32_t kf[A_REG ? KSTEPS : 1][4], vf[A_REG ? KSTEPS : 1][4];
  int tt = 0;       // tiles streamed so far (ring, P^T / dS^T, stage slots)
  int tq0 = 0;      // the current item's first tile

  auto wait_full = [&](int t) {
    mbar_wait_bounded(&s.full[t % NSTAGE], (t / NSTAGE) & 1);
  };
  auto issue_scores = [&](int t) {   // S^T = K . q~^T, dP^T = V . dO^T
    const int st = t % NSTAGE;
    if constexpr (A_REG) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<QS>::template rs<0>(sacc, kf[kk],
                                  kdesc_tile<DH>(s.q[st], QS, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<QS>::template rs<0>(pacc, vf[kk],
                                  kdesc_tile<DH>(s.d[st], QS, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<QS>::template ss<0>(sacc, kdesc_tile<KW>(s.k[w], KEYS, kk),
                                  kdesc_tile<DH>(s.q[st], QS, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<QS>::template ss<0>(pacc, kdesc_tile<DH>(s.v[w], KEYS, kk),
                                  kdesc_tile<DH>(s.d[st], QS, kk), kk > 0);
    }
    wgmma_commit();
  };
  // K-major descriptor of this warpgroup's 64 rows of a P^T / dS^T slot at
  // k16 step kj of the step's queries
  auto kdesc_t = [&](const __nv_bfloat16* slot, int kj) {
    return desc_add(make_desc<32>(slot + (kj / 2) * BLOCK * 32 +
                                  w * KEYS * 32), (kj % 2) * 32);
  };
  auto issue_grads = [&](int t) {
    const int st = t % NSTAGE;
    const __nv_bfloat16* pst = &s.ps[t % 2][0][0];   // [NDS][BLOCK, 32]
    const __nv_bfloat16* dst = &s.ds[t % 2][0][0];
#pragma unroll
    for (int kj = 0; kj < QSTEPS; ++kj)   // dV += P^T . dO (dO MN-major)
      mma_mn_ss<DH>(dv, kdesc_t(pst, kj), s.d[st], QS, kj);
#pragma unroll
    for (int kj = 0; kj < QSTEPS; ++kj)   // dK += dS^T . q~ (q~ MN-major)
      mma_mn_ss<DH>(dk, kdesc_t(dst, kj), s.q[st], QS, kj);
#pragma unroll
    for (int kj = 0; kj < BLOCK / 16; ++kj)   // dQ^T = K^T . dS^T
      Wgmma<32>::template ss<1, 1>(
          dqt, mndesc_tile<KW>(s.k[kj / 4], KEYS, a_span, kj % 4),
          desc_add(make_desc<32>(dst + b_tile * BLOCK * 32),
                   kj * 16 * 32 * 2),
          kj > 0);
    wgmma_commit();
  };
  auto make_tiles = [&](int t) {   // P^T and dS^T (bf16) to slot t % 2
    fence_regs(sacc);
    fence_regs(pacc);
    const int st = t % NSTAGE, q0 = (t - tq0) * QS;
    uint8_t* psb = reinterpret_cast<uint8_t*>(&s.ps[t % 2][0][0]);
    uint8_t* dsb = reinterpret_cast<uint8_t*>(&s.ds[t % 2][0][0]);
#pragma unroll
    for (int n = 0; n < QS / 8; ++n) {
      const int col = 8 * n + 2 * t4;   // query columns col, col + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(&s.lse[st][col]);
      const float2 dlt2 = *reinterpret_cast<const float2*>(&s.dlt[st][col]);
      const float lse_c[2] = {lse2.x, lse2.y}, dlt_c[2] = {dlt2.x, dlt2.y};
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int half = e / 2;
        float pv[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // exp2(-inf) = 0 drops the keys >= lk and the rows >= lq
          pv[c] = exp2f(real_k[half] && q0 + col + c < p.lq
                            ? fmaf(sacc[4 * n + e + c], LOG2E, -lse_c[c])
                            : -INFINITY);
          ds[c] = pv[c] * (pacc[4 * n + e + c] - dlt_c[c]);
        }
        const uint32_t off = (col / 32) * (BLOCK * 32 * 2) +
                             swz<32>((kr + 8 * half) * 64 + (col % 32) * 2);
        *reinterpret_cast<uint32_t*>(psb + off) = pack_bf16x2(pv[0], pv[1]);
        *reinterpret_cast<uint32_t*>(dsb + off) = pack_bf16x2(ds[0], ds[1]);
      }
    }
    fence_proxy_async();             // P^T / dS^T visible to wgmma ...
    bar_sync(BAR_DS, 2 * WG);        // ... of both warpgroups
  };
  auto stage_store = [&](int t) {    // dQ^T of tile t to its writer
    fence_regs(dqt);
    const int sb = t % NWRITER;
    mbar_wait_bounded(&s.st_empty[sb], ((t / NWRITER) & 1) ^ 1);
    float* st = s.stage[sb];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dd = d0 + warp * 16 + gq + 8 * (e >> 1);
        const int qq = q0w + 8 * j + 2 * t4 + (e & 1);
        if (DH >= 64 || dd < DH) st[qq * T::SPITCH + dd] = dqt[4 * j + e];
      }
    mbar_arrive(&s.st_full[sb]);
  };

  for (int it = 0, bh = g; bh < p.bh; ++it, bh += p.groups) {
    const int bi = bh / p.h, head = bh % p.h, n = p.n_qt;
    zero_acc(dk);
    zero_acc(dv);
    tq0 = tt;
    mbar_wait_bounded(&s.res_full, it & 1);
    if constexpr (A_REG) {
      load_a_steps<KW>(s.k[w], warp * 16 + gq, t4, kf);
      load_a_steps<DH>(s.v[w], warp * 16 + gq, t4, vf);
    }
    wait_full(tt);
    wgmma_fence();
    issue_scores(tt);
    wgmma_wait<0>();
    make_tiles(tt);
    // Tile t+1's score products are issued before tile t's gradient
    // products, and its exp2 work runs while those are on the tensor cores
    // (at DH = 128 after them: S^T and dP^T beside dK, dV and dQ^T would
    // not fit the registers); tile t's dQ^T goes to the stage once they
    // are done.  The last tile is its own step, so that no wgmma is issued
    // or waited for under a runtime condition.
    auto grads_done = [&](int t) {
      wgmma_wait<0>();
      // both warpgroups' products of tile t are done: slot t % 2 is free
      bar_sync(BAR_DS, 2 * WG);
      if (tid == 0) mbar_arrive(&s.empty[t % NSTAGE]);
      stage_store(t);
    };
    for (int t = tt; t + 1 < tt + n; ++t) {
      wait_full(t + 1);
      if constexpr (OVERLAP) {
        wgmma_fence();
        issue_scores(t + 1);
        issue_grads(t);
        wgmma_wait<1>();
        make_tiles(t + 1);
        grads_done(t);
      } else {
        wgmma_fence();
        issue_grads(t);
        grads_done(t);
        wgmma_fence();
        issue_scores(t + 1);
        wgmma_wait<0>();
        make_tiles(t + 1);
      }
    }
    wgmma_fence();
    issue_grads(tt + n - 1);
    grads_done(tt + n - 1);
    tt += n;
    if (tid == 0) mbar_arrive(&s.res_empty);   // K and V read for the last time
    fence_regs(dk);
    fence_regs(dv);
    store_rows<DH>(p.dk, bi, head, p.lk, p.h, p.d, r0, dk, 1.f, t4);
    store_rows<DH>(p.dv, bi, head, p.lk, p.h, p.d, r0, dv, 1.f, t4);
  }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_full_bwd_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  BwdSmem<DH>& s = smem_storage<BwdSmem<DH>>(smem_raw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < Tile<DH>::NSTAGE; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], 2);
    }
    mbar_init(&s.res_full, 1);
    mbar_init(&s.res_empty, 2);
    for (int i = 0; i < NWRITER; ++i) {
      mbar_init(&s.st_full[i], 2 * WG);
      mbar_init(&s.st_empty[i], 1);
    }
    mbar_init_fence();
    // slots in the order the CTAs start (see the header: no deadlock)
    s.slot = take_ticket(p.cnt + (long long)p.bh * p.n_qt);
  }
  __syncthreads();
  const int g = (int)s.slot / p.n_kb, kb = (int)s.slot % p.n_kb;
  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    setmaxnreg_dec<56>();
    const int warp = (threadIdx.x - 2 * WG) / 32;
    if (threadIdx.x == 2 * WG)
      producer<DH>(p, s, g, kb);
    else if (warp >= 1)
      writer<DH>(p, s, g, kb, warp - 1);
  } else {
    setmaxnreg_inc<224>();
    consumer<DH>(p, s, wg, g, kb);
  }
}

template <int DH>
int launch(const void* qs, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, int b, int dm, long long k_sb,
           long long k_sl, long long k_sh, long long v_sb, long long v_sl,
           long long v_sh, long long do_sb, long long do_sl, long long do_sh,
           BwdParams& p, cudaStream_t stream) {
  using T = Tile<DH>;
  const int pitch = (p.lq + 3) / 4 * 4;
  const long long q_sh = dm, q_sl = (long long)p.h * dm,
                  q_sb = (long long)p.lq * p.h * dm;
  const bool ok =
      make_map_heads_bf16<DH>(&p.tq, qs, dm, p.h, p.lq, b, q_sh, q_sl, q_sb,
                              T::QS) &&
      make_map_heads_bf16<DH>(&p.tdo, dout, dm, p.h, p.lq, b, do_sh, do_sl,
                              do_sb, T::QS) &&
      make_map_heads_bf16<T::KW>(&p.tk, k, dm, p.h, p.lk, b, k_sh, k_sl,
                                 k_sb, KEYS) &&
      make_map_heads_bf16<DH>(&p.tv, v, dm, p.h, p.lk, b, v_sh, v_sl, v_sb,
                              KEYS) &&
      make_map_f32(&p.tlse, lse, p.lq, pitch, b * p.h, T::QS) &&
      make_map_f32(&p.tdlt, delta, p.lq, pitch, b * p.h, T::QS);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(flash_full_bwd_kernel<DH>),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<BwdSmem<DH>>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  flash_full_bwd_kernel<DH><<<p.groups * p.n_kb, NTHREADS,
                              smem_bytes<BwdSmem<DH>>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int tile_of(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

}  // namespace

// The prep launch on `stream`: q~ = bf16(q * scale) into qs, a contiguous
// [b, lq, h, dm] (columns d .. dm - 1 zero), delta = rowsum(dO * O) into
// the f32 [b, h, pitch] layout (pitch = lq rounded up to 4, columns < lq
// written), and n_cnt counters zeroed.  q / o / dout [b, lq, h, d] bf16
// views read through (batch, row, head) strides in elements, last dimension
// contiguous.  Returns the launch's cudaError_t (0 = success).
extern "C" int odgs_flash_full_bwd_prep_bf16(
    const void* q, const void* o, const void* dout, void* qs, void* delta,
    void* cnt, int b, int lq, int h, int d, int dm, int n_cnt, float scale,
    long long q_sb, long long q_sl, long long q_sh, long long o_sb,
    long long o_sl, long long o_sh, long long do_sb, long long do_sl,
    long long do_sh, void* stream) {
  if (d < 1 || d > 128 || dm < d || n_cnt < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)b * lq * h;
  const long long by_rows = (rows + PREP_ROWS - 1) / PREP_ROWS;
  const long long by_cnt =
      ((long long)n_cnt + PREP_ROWS * 32 - 1) / (PREP_ROWS * 32);
  const long long blocks = by_rows > by_cnt ? by_rows : by_cnt;
  if (blocks == 0) return 0;
  PrepParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.qs = static_cast<__nv_bfloat16*>(qs);
  p.delta = static_cast<float*>(delta);
  p.cnt = static_cast<unsigned*>(cnt);
  p.q_sb = q_sb, p.q_sl = q_sl, p.q_sh = q_sh;
  p.o_sb = o_sb, p.o_sl = o_sl, p.o_sh = o_sh;
  p.do_sb = do_sb, p.do_sl = do_sl, p.do_sh = do_sh;
  p.b = b, p.lq = lq, p.h = h, p.d = d, p.dm = dm;
  p.pitch = (lq + 3) / 4 * 4;
  p.n_cnt = n_cnt;
  p.scale = scale;
  flash_full_bwd_prep_kernel<<<(unsigned)blocks, PREP_ROWS * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The main pass on `stream`, after the prep launch of the same call (its
// counters must read 0).  qs: the prep's q~ [b, lq, h, dm]; k / v
// [b, lk, h, *] and dout [b, lq, h, *] bf16 views read through (batch,
// row, head) strides in elements, last dimension contiguous; the maps read
// `dm` columns (d <= dm <= the tile width 16 / 32 / 64 / 128; dm > d for
// the wrapper's zero-padded copies), under TMA's rule
// (ops/attention.py::full_takes_view).  lse and delta: f32 [b, h, pitch].
// acc: f32 scratch of b*h*n_qt*QS*DH floats, cnt: the prep's counters
// (b*h*n_qt + 1), n_qt = ceil(lq / QS) (ops/attention.py::full_bwd_plan).
// dq [b, lq, h, d] and dk / dv [b, lk, h, d]: contiguous bf16 outputs.
// dq_scale = bf16(d^-1/2).  groups: CTAs per key block, 1 .. b*h.
extern "C" int odgs_flash_full_bwd_bf16(
    const void* qs, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* acc, void* cnt, void* dq,
    void* dk, void* dv, int b, int lq, int lk, int h, int d, int dm,
    int groups, float dq_scale, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    long long do_sb, long long do_sl, long long do_sh, void* stream) {
  if (b == 0 || h == 0 || lq == 0 || lk == 0) return 0;
  const int tile = tile_of(d);
  if (d < 1 || d > 128 || dm < d || dm > tile || groups < 1 ||
      groups > b * h)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qs_rows = tile > 64 ? 32 : 64;
  BwdParams p;
  p.acc = static_cast<float*>(acc);
  p.cnt = static_cast<unsigned*>(cnt);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lq = lq;
  p.lk = lk;
  p.h = h;
  p.d = d;
  p.bh = b * h;
  p.n_qt = (lq + qs_rows - 1) / qs_rows;
  p.n_kb = (lk + BLOCK - 1) / BLOCK;
  p.groups = groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ODGS_BWD_ARGS                                                       \
  qs, k, v, dout, lse, delta, b, dm, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,    \
      do_sb, do_sl, do_sh, p, s
  const int err = tile == 16   ? launch<16>(ODGS_BWD_ARGS)
                  : tile == 32 ? launch<32>(ODGS_BWD_ARGS)
                  : tile == 64 ? launch<64>(ODGS_BWD_ARGS)
                               : launch<128>(ODGS_BWD_ARGS);
#undef ODGS_BWD_ARGS
  if (err != 0) return err;
  EpiParams e;
  e.acc = p.acc;
  e.dq = static_cast<__nv_bfloat16*>(dq);
  e.b = b, e.lq = lq, e.h = h, e.d = d, e.dh = tile;
  e.rows = p.n_qt * qs_rows;
  e.scale = dq_scale;
  const long long n = (long long)b * lq * h * ((d & 1) == 0 ? d / 2 : d);
  const long long blocks = (n + 255) / 256;
  flash_full_bwd_epilogue_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                   256, 0, s>>>(e);
  return static_cast<int>(cudaGetLastError());
}
