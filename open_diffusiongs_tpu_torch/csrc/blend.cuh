// Shared pieces of the two tile-blend kernels (blend_fwd.cu, blend_bwd.cu):
// the blend's constants, the warp rectangles, the per-warp cp.async ring
// of candidate rows and the conservative whole-candidate cull.
//
// Warp rectangles: a 16x16 tile is cut into eight 8x4-pixel rectangles,
// warp w of the tile owning columns (w % 2) * 8 .. + 7 and rows
// (w / 2) * 4 .. + 3; lane l is pixel (l % 8, l / 8) of its rectangle.
//
// The cull (ops/blend_kernel.py::cull_mask mirrors it in f32): a pixel
// blends a candidate only if power <= 0 and alpha = min(0.99, o e^power)
// >= 1/255, i.e. Q = a dx^2 + 2 b dx dy + c dy^2 <= 2 tau with
// tau = ln(255 o).  For a positive-definite conic the ellipse Q <= q has
// the bounding box |dx| <= sqrt(q c / det), |dy| <= sqrt(q a / det),
// det = ac - b^2.  f32 rounding of the kernel's power (the products, the
// pixel offset) moves Q by at most 6 eps (a dx^2 + c dy^2 + 2|b dx dy|)
// <= 12 eps (a + c)^2 / det * Q, so q takes the relative slack
// rho = 32 eps (a + c)^2 / det (as a factor 1 + 2 rho >= 1 / (1 - rho)
// for rho <= 1/2), tau a slack of 1e-3 relative and 1e-4 absolute (logf,
// expf and the alpha product), and the half-extents 1e-3 relative, 0.01 px
// and 1e-5 |mean| for 1/det, the square root and the compares.
// No cull unless the rule is certain: a > 0, det > 0, rho <= 1/2 and the
// mean, det and tau finite (a NaN power blends at alpha 0.99 through
// fminf).  Always cull when o < 1/255: then alpha <= o everywhere.  A
// culled (candidate, rectangle) pair is one every pixel of the rectangle
// skips anyway, so no output changes.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace odgs_blend {

constexpr int TILE = 16;
constexpr int PPT = TILE * TILE;   // pixels per tile
constexpr int TILE_WARPS = PPT / 32;
constexpr int RECT_W = 8, RECT_H = 4;   // one warp's pixels
constexpr int NA = 10;             // attribute columns
constexpr int CH = 32;             // candidates per ring stage (one per lane)
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;              // forward.cu:344
constexpr float ALPHA_MIN = 1.0f / 255.0f;      // forward.cu:345
constexpr float EARLY_STOP_T = 1e-4f;           // forward.cu:348
constexpr float CULL_RHO = 32.0f * FLT_EPSILON;

// Pixel of lane `lane` in tile-warp `w` (0..7), as an index into the tile.
__device__ __forceinline__ int rect_pixel(int w, int lane) {
  return ((w / 2) * RECT_H + lane / RECT_W) * TILE + (w % 2) * RECT_W +
         lane % RECT_W;
}

// True when no pixel centre of [rx0, rx1] x [ry0, ry1] can blend the
// candidate row a (header note).  Round-to-nearest intrinsics keep nvcc
// from contracting the arithmetic, so the f32 mirror sees the same values.
__device__ __forceinline__ bool misses_rect(const float* a, float rx0,
                                            float ry0, float rx1, float ry1) {
  const float x = a[0], y = a[1], ca = a[2], cb = a[3], cc = a[4], o = a[8];
  if (o < ALPHA_MIN) return true;
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  const float rdet = __frcp_rn(det);
  const float s = __fadd_rn(ca, cc);
  const float rho = __fmul_rn(__fmul_rn(CULL_RHO, __fmul_rn(s, s)), rdet);
  const float tau = logf(__fmul_rn(255.f, o));
  if (!(ca > 0.f && det > 0.f && rho <= 0.5f) || !isfinite(x) ||
      !isfinite(y) || !isfinite(det) || !isfinite(tau))
    return false;
  const float q =
      __fmul_rn(__fmul_rn(2.f, __fadd_rn(__fmul_rn(tau, 1.001f), 1e-4f)),
                __fadd_rn(1.f, __fmul_rn(2.f, rho)));
  const float hx = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsqrt_rn(__fmul_rn(__fmul_rn(q, cc), rdet)),
                          1.001f), 0.01f),
      __fmul_rn(1e-5f, fabsf(x)));
  const float hy = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsqrt_rn(__fmul_rn(__fmul_rn(q, ca), rdet)),
                          1.001f), 0.01f),
      __fmul_rn(1e-5f, fabsf(y)));
  return __fadd_rn(x, hx) < rx0 || __fsub_rn(x, hx) > rx1 ||
         __fadd_rn(y, hy) < ry0 || __fsub_rn(y, hy) > ry1;
}

// One (pixel, candidate) pair of the blend, as both kernels form it (one
// function, so the backward's re-walk rebuilds the forward's T bit for
// bit): power = -1/2 (a dx^2 + c dy^2) - b dx dy, IEEE expf, alpha =
// min(0.99, o e^power), or 0 when the pixel skips the candidate (power > 0
// or alpha < 1/255).
struct Pair {
  float dx, dy, gexp, og, alpha;
};

__device__ __forceinline__ Pair blend_pair(const float* row, float px,
                                           float py) {
  const float2* a = reinterpret_cast<const float2*>(row);   // 8-byte rows
  const float2 xy = a[0], ab = a[1], cr = a[2], oz = a[4];
  Pair r;
  r.dx = xy.x - px;
  r.dy = xy.y - py;
  const float power =
      -0.5f * (ab.x * r.dx * r.dx + cr.x * r.dy * r.dy) - ab.y * r.dx * r.dy;
  r.gexp = expf(power);
  r.og = oz.x * r.gexp;
  const float alpha = fminf(ALPHA_MAX, r.og);
  r.alpha = !(power > 0.f) && !(alpha < ALPHA_MIN) ? alpha : 0.f;
  return r;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp stages candidate slots [base, base + CH) of its tile (those
// below `count`) into `stage` ([CH][NA] f32 rows): the chunk's 160 8-byte
// words are spread over the lanes word by word, so one copy instruction
// touches ~7 rows instead of 32.  `row` is lane l's table row for slot
// base + l; commits one cp.async group (empty past `count`).
__device__ __forceinline__ void stage_rows(float* stage,
                                           const float* __restrict__ packed,
                                           int row, int base, int count,
                                           int lane) {
  constexpr int WORDS = NA / 2;   // 8-byte words per row
#pragma unroll
  for (int r = 0; r < WORDS; ++r) {
    const int word = r * 32 + lane;        // < CH * WORDS
    const int c = word / WORDS, part = word % WORDS;
    const int src_row = __shfl_sync(FULL, row, c);
    if (base + c < count)
      cp_async8(stage + c * NA + 2 * part,
                packed + static_cast<long long>(src_row) * NA + 2 * part);
  }
  cp_async_commit();
}

// Writes the lanes set in `todo` to list[0, popc(todo)) in lane order and
// returns their number (the warp's candidates of a chunk, so a batch reads
// its candidates with independent loads instead of a serial __ffs chain).
__device__ __forceinline__ int compact(unsigned todo, int* list, int lane) {
  if ((todo >> lane) & 1u) list[__popc(todo & ((1u << lane) - 1u))] = lane;
  __syncwarp();
  return __popc(todo);
}

// Lane l's table row for slot base + l (0 past count, where nothing is
// copied).
__device__ __forceinline__ int slot_row(const int* __restrict__ tidx,
                                        int base, int count, int lane) {
  return base + lane < count ? tidx[base + lane] : 0;
}

}  // namespace odgs_blend
