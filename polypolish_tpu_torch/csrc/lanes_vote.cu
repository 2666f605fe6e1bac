// Lanes vote kernel: dense pileup counts from the packed4 lane pack.
//
// Replaces the TPU kernel polypolish_tpu/ops/vote_lanes.py
// _make_lanes_kernel, body "packed4" (launched by _lanes_call_one).
//
// Contract.  vb is int32 (n_rows, tile_w); byte k of int32 row q at
// column c is the vocab byte of byte-row 4q+k at position
// tile * tile_w + c, where tile owns rows [tile_row_start[tile],
// tile_row_start[tile + 1]).  out[v, tile * tile_w + c] (int32, 8 rows
// of n_tiles * tile_w) = number of those bytes equal to v, for v < 8;
// bytes >= 8 (pad 255, sparse tier) count nothing.
//
// What bounds it on an H100: bytes.  Every pack byte is read once (one
// vote byte per slot) and the (8, P) int32 output written once; per
// byte the work is a handful of integer ops, far below the ~100 int ops
// per byte the card can spend before memory is the limit.
//
// Design.  The TPU grid walked blocks in order and re-zeroed a tile on
// its first block; Hopper runs CTAs in parallel in no order, so a CTA
// here owns one (tile, 128-column group) and each thread owns one
// column: it walks all of its tile's int32 rows (loads coalesced along
// tile_w, 512 B per warp per row) and writes each of its 8 output
// counts exactly once — no atomics, no zero-fill pass, and tiles with
// no rows still get their zeros.  The TPU's carry-save planes stay:
// each byte adds 1 << 8*(v & 3) into `lo` (v < 4) or `hi` (4 <= v < 8),
// so four bytes cost a few ALU ops and no indexed counter array (which
// would spill to local memory).  A byte field holds at most 255, so the
// planes are unpacked into eight int32 registers every 63 int32 rows
// (252 byte-rows) — deep repeat tiles reach thousands of rows.
// cp.async/TMA staging and tuning are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // columns per CTA
constexpr int kFlushRows = 63;  // int32 rows per plane flush: 4*63 <= 255

__global__ void __launch_bounds__(kThreads)
lanes_vote_packed4_kernel(const uint32_t* __restrict__ vb,
                          const int64_t* __restrict__ tile_row_start,
                          int32_t* __restrict__ out, int64_t n_tiles,
                          int tile_w, int groups) {
  const int64_t tile = blockIdx.x / groups;
  const int col = (blockIdx.x % groups) * kThreads + threadIdx.x;
  const int64_t r_begin = tile_row_start[tile];
  const int64_t r_end = tile_row_start[tile + 1];

  uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0, c6 = 0, c7 = 0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kFlushRows) {
    const int64_t r1 = r0 + kFlushRows < r_end ? r0 + kFlushRows : r_end;
    const uint32_t* p = vb + r0 * tile_w + col;
    uint32_t lo = 0, hi = 0;
#pragma unroll 4
    for (int64_t r = r0; r < r1; ++r, p += tile_w) {
      const uint32_t x = __ldg(p);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t v = (x >> (8 * k)) & 0xFFu;
        const uint32_t one = 1u << ((v & 3u) << 3);
        lo += v < 4u ? one : 0u;
        hi += v - 4u < 4u ? one : 0u;  // 4 <= v < 8 (unsigned wrap)
      }
    }
    c0 += lo & 0xFFu;
    c1 += (lo >> 8) & 0xFFu;
    c2 += (lo >> 16) & 0xFFu;
    c3 += lo >> 24;
    c4 += hi & 0xFFu;
    c5 += (hi >> 8) & 0xFFu;
    c6 += (hi >> 16) & 0xFFu;
    c7 += hi >> 24;
  }
  const int64_t width = n_tiles * tile_w;
  int32_t* o = out + tile * tile_w + col;
  o[0] = (int32_t)c0;
  o[width] = (int32_t)c1;
  o[2 * width] = (int32_t)c2;
  o[3 * width] = (int32_t)c3;
  o[4 * width] = (int32_t)c4;
  o[5 * width] = (int32_t)c5;
  o[6 * width] = (int32_t)c6;
  o[7 * width] = (int32_t)c7;
}

}  // namespace

// vb: int32 (n_rows, tile_w); tile_row_start: int64 (n_tiles + 1),
// non-decreasing, last entry <= n_rows; out: int32 (8, n_tiles*tile_w).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int lanes_vote_packed4(const void* vb, const void* tile_row_start,
                                  void* out, int64_t n_tiles, int tile_w,
                                  void* stream) {
  if (n_tiles <= 0 || tile_w <= 0 || tile_w % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  const int groups = tile_w / kThreads;
  const int64_t grid = n_tiles * groups;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  lanes_vote_packed4_kernel<<<(unsigned)grid, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)vb, (const int64_t*)tile_row_start, (int32_t*)out,
      n_tiles, tile_w, groups);
  return (int)cudaGetLastError();
}
