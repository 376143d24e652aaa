// Hopper building blocks shared by the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, flash_full_fwd.cu, flash_full_bwd.cu): TMA tensor
// maps and loads,
// mbarriers, warpgroup register hand-off, and wgmma on bf16 tiles.
//
// Shared-memory tiles are [rows, DH] bf16 with DH in {16, 32, 64}: one row
// is one swizzle span (32, 64 or 128 bytes), written by TMA with the
// matching swizzle (SWIZZLE_32B / 64B / 128B) and read by wgmma through a
// descriptor of the same layout type.  The general route's kernels also
// take DH = 128, stored as two such [rows, 64] tiles (span_of).  Every tile starts 1024-byte aligned,
// so the swizzle phase is the row index and the descriptors' base offset
// is 0.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace odgs {

// ---------------------------------------------------------------------------
// Host: tensor maps.  cuTensorMapEncodeTiled is a driver-API function; it is
// looked up through the runtime, so the library needs no -lcuda.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Every helper below that takes DH relies on one [rows, DH] bf16 tile row
// being exactly one swizzle span (2 * DH bytes = 128 / 64 / 32 B): the
// swizzle, the TMA box and the wgmma descriptors (make_desc) all assume it.
// A tile of DH = 128 columns (the general route's wide heads) has 256-byte
// rows, two 128-byte spans: it is stored as two single-span [rows, 64]
// tiles one after the other (`span_of`, the `*_tile` helpers below), so
// every single-span helper works on one of them.
#define ODGS_SINGLE_SPAN(DH)                                                 \
  static_assert((DH) == 16 || (DH) == 32 || (DH) == 64,                      \
                "a tile row must be exactly one swizzle span: DH 16, 32, 64")

// Columns of one swizzle span of a DH-wide tile: DH itself up to 64, else
// 64 (DH = 128 is two spans).
template <int DH>
__host__ __device__ constexpr int span_of() {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128,
                "tile widths: 16, 32, 64, 128");
  return DH > 64 ? 64 : DH;
}

template <int DH>
constexpr CUtensorMapSwizzle swizzle_of() {
  ODGS_SINGLE_SPAN(DH);
  return DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A [b, rows, width] bf16 view (row and batch strides in elements, the last
// dimension contiguous) read in boxes of [box_rows, DH] at coordinates
// (column, row, batch).  Rows >= `rows` read as 0.  TMA needs a 16-byte
// aligned base and strides that are multiples of 16 bytes (the wrappers
// check both).
template <int DH>
inline bool make_map_bf16(CUtensorMap* map, const void* base, int width,
                          int rows, int b, long long row_stride,
                          long long batch_stride, int box_rows) {
  ODGS_SINGLE_SPAN(DH);
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)b};
  // a batch stride of a single batch element is never used; keep it legal
  const long long bs = b > 1 ? batch_stride : (long long)rows * row_stride;
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[3] = {(cuuint32_t)DH, (cuuint32_t)box_rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle_of<DH>(), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [b, rows, h, d] bf16 view (element (bi, r, head, c) at bi*sb + r*sl +
// head*sh + c, strides in elements, the last dimension contiguous) as the
// 4-D map {d, h, rows, b}, read in boxes of [box_rows, DH] (one head) at
// coordinates (0, head, row, batch).  Columns >= d (d <= DH) and rows >=
// `rows` read as 0, so a head narrower than the tile arrives zero-filled.
// TMA needs a 16-byte aligned base, and d * 2 and the strides of the
// dimensions longer than 1 multiples of 16 bytes (the wrapper checks
// them); the stride of a dimension of extent 1 is never used and is
// replaced by the packed one.
// For DH = 128 the box is one span, [box_rows, 64]: a tile takes two
// loads (tma_load_heads).
template <int DH>
inline bool make_map_heads_bf16(CUtensorMap* map, const void* base, int d,
                                int h, int rows, int b, long long sh,
                                long long sl, long long sb, int box_rows) {
  constexpr int SP = span_of<DH>();
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || d > DH) return false;
  if (h == 1) sh = d;
  if (rows == 1) sl = (long long)h * sh;
  if (b == 1) sb = (long long)rows * sl;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)rows,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SP, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle_of<SP>(), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [n, rows_pitch] f32 matrix read in boxes of [1, box] at (column, row);
// columns >= `cols` read as 0.  rows_pitch * 4 must be a multiple of 16.
inline bool make_map_f32(CUtensorMap* map, const void* base, int cols,
                         int rows_pitch, int n, int box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)rows_pitch * 4};
  const cuuint32_t boxd[2] = {(cuuint32_t)box, 1};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, boxd, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of a kernel whose storage struct needs 1024-byte
// alignment: the struct's size plus the worst-case slack.
template <typename S>
constexpr int smem_bytes() {
  return (int)sizeof(S) + 1024;
}

// ---------------------------------------------------------------------------
// Device
// ---------------------------------------------------------------------------

template <typename S>
__device__ __forceinline__ S& smem_storage(uint8_t* raw) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(raw);
  return *reinterpret_cast<S*>((p + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make barrier initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A [box_rows, DH] one-head tile of a make_map_heads_bf16<DH> map at
// (head, row, batch), span by span: span sp (columns 64 sp ..) lands at
// dst + sp * box_rows * 64.  One load for DH <= 64.
template <int DH>
__device__ __forceinline__ void tma_load_heads(__nv_bfloat16* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int head,
                                               int row, int bi,
                                               int box_rows) {
  constexpr int SP = span_of<DH>();
#pragma unroll
  for (int sp = 0; sp < DH / SP; ++sp)
    tma_load_4d(dst + sp * box_rows * SP, map, bar, sp * SP, head, row, bi);
}

// Named barrier `id` (ids 1.. are free: 0 is __syncthreads) over n threads
// (a multiple of 32; 128: one warpgroup): bar_sync arrives and waits,
// bar_arrive arrives without waiting (a signal to the threads that sync on
// it).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: reads after a
// wgmma_wait are not hoisted above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of element bytes `off` of a [rows, DH] bf16 tile after the
// TMA swizzle of its row width (Swizzle<3|2|1, 4, 3>).
template <int DH>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  ODGS_SINGLE_SPAN(DH);
  constexpr uint32_t mask = DH == 64 ? 7u : DH == 32 ? 3u : 1u;
  return off ^ (((off >> 7) & mask) << 4);
}

// The wgmma A fragments (register form) of rows row0 and row0 + 8 of a
// swizzled [rows, DH] bf16 tile, per warp of the warpgroup: step kk,
// element i holds the pair at row row0 + 8 (i & 1), columns
// 16 kk + 2 t4 + 8 (i >> 1) (+1).
template <int DH>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* tile,
                                             int row0, int t4,
                                             uint32_t (&f)[DH / 16][4]) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(tile);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1), col = kk * 16 + 2 * t4 + 8 * (i >> 1);
      f[kk][i] = *reinterpret_cast<const uint32_t*>(
          base + swz<DH>(row * DH * 2 + col * 2));
    }
}

// load_a_frags' inverse: f written back to the same places of the tile.
template <int DH>
__device__ __forceinline__ void store_a_frags(__nv_bfloat16* tile, int row0,
                                              int t4,
                                              const uint32_t (&f)[DH / 16][4]) {
  uint8_t* base = reinterpret_cast<uint8_t*>(tile);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1), col = kk * 16 + 2 * t4 + 8 * (i >> 1);
      *reinterpret_cast<uint32_t*>(base + swz<DH>(row * DH * 2 + col * 2)) =
          f[kk][i];
    }
}

// wgmma shared-memory descriptor of a swizzled [rows, DH] bf16 tile.
// K-major operand (DH is the reduction axis, e.g. K of q~.K^T): 8-row
// groups SBO = 8 * DH * 2 bytes apart; step k16 by adding 32 bytes.
// MN-major operand (rows are the reduction axis, e.g. V of P.V, read with
// the transpose bit): the same 8-row groups along the reduction; one
// swizzle span covers all DH columns, so the leading offset is never
// stepped; step k16 by adding 16 rows.  Both set LBO = SBO: with a tile
// row exactly one swizzle span (DH 16 / 32 / 64, checked below) whichever
// of the two offsets the hardware reads for a single-span operand, it is
// the 8-row group stride.  A wider row (several spans) needs its own LBO.
template <int DH>
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  ODGS_SINGLE_SPAN(DH);
  constexpr uint64_t layout = DH == 64 ? 1 : DH == 32 ? 2 : 3;
  constexpr uint64_t group = (8 * DH * 2) >> 4;
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (group << 16) |
         (group << 32) | (layout << 62);
}

// Descriptor advanced by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// The span-stored [rows, DH] tiles (DH up to 128; see span_of).
// K-major descriptor of k16 step kk (columns 16 kk ..) of such a tile.
template <int DH>
__device__ __forceinline__ uint64_t kdesc_tile(const __nv_bfloat16* tile,
                                               int rows, int kk) {
  constexpr int SP = span_of<DH>(), PER = SP / 16;
  return desc_add(make_desc<SP>(tile + (kk / PER) * rows * SP),
                  (kk % PER) * 32);
}

// MN-major descriptor of span sp at k16 step kj (rows 16 kj ..).
template <int DH>
__device__ __forceinline__ uint64_t mndesc_tile(const __nv_bfloat16* tile,
                                                int rows, int sp, int kj) {
  constexpr int SP = span_of<DH>();
  return desc_add(make_desc<SP>(tile + sp * rows * SP), kj * 16 * SP * 2);
}

// load_a_frags over all spans of a span-stored tile: f[kk] for k16 steps
// kk of the whole width.
template <int DH>
__device__ __forceinline__ void load_a_frags_tile(const __nv_bfloat16* tile,
                                                  int rows, int row0, int t4,
                                                  uint32_t (&f)[DH / 16][4]) {
  constexpr int SP = span_of<DH>();
#pragma unroll
  for (int sp = 0; sp < DH / SP; ++sp)
    load_a_frags<SP>(tile + sp * rows * SP, row0, t4,
                     *reinterpret_cast<uint32_t(*)[SP / 16][4]>(
                         &f[sp * SP / 16]));
}

// store_a_frags over all spans of a span-stored tile.
template <int DH>
__device__ __forceinline__ void store_a_frags_tile(__nv_bfloat16* tile,
                                                   int rows, int row0, int t4,
                                                   uint32_t (&f)[DH / 16][4]) {
  constexpr int SP = span_of<DH>();
#pragma unroll
  for (int sp = 0; sp < DH / SP; ++sp)
    store_a_frags<SP>(tile + sp * rows * SP, row0, t4,
                      *reinterpret_cast<uint32_t(*)[SP / 16][4]>(
                          &f[sp * SP / 16]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16 bf16 -> f32 wgmma, D (+)= A . B.  D holds N / 2 floats a thread:
// d[4j + e] is row 16 * warp + g + 8 * (e >> 1), column 8 j + 2 t4 + (e & 1)
// (g = lane / 4, t4 = lane % 4), the mma.sync C layout per n8 tile.  TB is
// B's transpose bit: 0 for a K-major B, 1 for an MN-major B.  scale_d = 0
// overwrites D.  `rs` takes A from registers; `ss` (A from shared memory)
// exists for N = 16, 32 and 64, the backward kernels' products on staged
// tiles, and for N = 128, #5s's scores on q~ in shared memory; at N = 16
// and 32 its TA is A's transpose bit (1: an MN-major A).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // A from registers (the m64k16 fragment of mma.sync's m16n8k16 per warp)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
  // A from shared memory (K-major descriptor, or MN-major with TA = 1)
  template <int TB, int TA = 0>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  // A from registers (the m64k16 fragment of mma.sync's m16n8k16 per warp)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
  // A from shared memory (K-major descriptor, or MN-major with TA = 1)
  template <int TB, int TA = 0>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // A from registers (the m64k16 fragment of mma.sync's m16n8k16 per warp)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
  // A from shared memory (K-major descriptor)
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // A from registers (the m64k16 fragment of mma.sync's m16n8k16 per warp)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
  // A from shared memory (K-major descriptor)
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  // A from shared memory, D = A . B: the accumulator is written only, so
  // its registers are free before the product (ss with scale_d = 0)
  template <int TB>
  static __device__ __forceinline__ void ss_init(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),
        "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]),
        "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]),
        "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]),
        "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]),
        "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(a), "l"(b), "r"(0), "n"(TB));
  }
};

// acc (+)= A . B over one k16 step kj of a span-stored [rows, DH] tile B
// read MN-major (its rows are the reduction axis, its DH columns the
// product's N): one m64n{span} wgmma per span, each on its slice of the
// accumulator.  The slices of a DH = 128 accumulator hold n8 tiles 8 sp ..
// 8 sp + 7, the layout one m64n128 product would give, so the epilogues
// read acc[4 n + e] as column 8 n + 2 t4 + (e & 1) for any DH.  Two n64
// products, not one n128, because an MN-major operand two spans wide needs
// its own leading offset (make_desc's comment).
template <int DH>
__device__ __forceinline__ void mma_mn(float (&acc)[DH / 2],
                                       const uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int rows,
                                       int kj) {
  constexpr int SP = span_of<DH>();
#pragma unroll
  for (int sp = 0; sp < DH / SP; ++sp)
    Wgmma<SP>::template rs<1>(
        *reinterpret_cast<float(*)[SP / 2]>(&acc[sp * SP / 2]), a,
        mndesc_tile<DH>(tile, rows, sp, kj), 1);
}

// mma_mn with A from shared memory: acc (+)= A . B over one k16 step of a
// span-stored B read MN-major, `a` the K-major descriptor of A's k16 step.
template <int DH>
__device__ __forceinline__ void mma_mn_ss(float (&acc)[DH / 2], uint64_t a,
                                          const __nv_bfloat16* tile, int rows,
                                          int kj) {
  constexpr int SP = span_of<DH>();
#pragma unroll
  for (int sp = 0; sp < DH / SP; ++sp)
    Wgmma<SP>::template ss<1>(
        *reinterpret_cast<float(*)[SP / 2]>(&acc[sp * SP / 2]), a,
        mndesc_tile<DH>(tile, rows, sp, kj), 1);
}

}  // namespace odgs
