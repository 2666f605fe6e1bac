// Lanes vote kernels: dense pileup counts from a lane pack, in each of
// its three row layouts.
//
// Replaces the TPU kernel polypolish_tpu/ops/vote_lanes.py
// _make_lanes_kernel (launched by _lanes_call_one) in all its bodies:
//   lanes_vote_packed4  body "packed4": int32 rows, four vote bytes each;
//   lanes_vote_bytes    bodies "packed" and "cmp": one vote byte per row
//                       (the two TPU bodies compute one function on one
//                       layout and differ only in how the TPU's vector
//                       unit reduced it, so one kernel serves both);
//   lanes_vote_packed8  body "packed8": int32 rows, eight vote nibbles
//                       each, nibble 15 = pad.
//
// Contract.  Row r of tile t's rows [tile_row_start[t],
// tile_row_start[t + 1]) holds, at column c, the vote slots of position
// t * tile_w + c.  out[v, t * tile_w + c] (int32, 8 rows of
// n_tiles * tile_w) = number of those slots equal to v, for v < 8; slot
// values >= 8 (pad 255, sparse tier, nibbles 8-15) count nothing.
// Bytes are read unsigned: an int8 pad of -1 is 255.
//
// What bounds it on an H100: bytes.  Every pack byte is read once and
// the (8, P) int32 output written once, so the integer work per byte
// has to stay below what the card can issue while memory streams it.
//
// Design.  The TPU grid walked blocks in order and re-zeroed a tile on
// its first block; Hopper runs CTAs in parallel in no order, so a CTA
// here owns one (tile, 128-column group) and each thread owns one
// column: it walks all of its tile's rows (loads coalesced along
// tile_w) and writes each of its 8 output counts exactly once — no
// atomics, no zero-fill pass, and tiles with no rows still get their
// zeros.
//
// Byte slots (packed4, bytes) keep the TPU's carry-save planes: each
// slot adds 1 << 8*(v & 3) into `lo` (v < 4) or `hi` (4 <= v < 8), so a
// slot costs a few ALU ops and no indexed counter array (which would
// spill to local memory).  A byte field holds at most 255, so the
// planes are unpacked into eight int32 registers every kFlush rows,
// where kFlush times the slots per row is at most 255 — deep repeat
// tiles reach thousands of rows.  A decoder type per layout supplies
// the row type, the slots per row and the flush period; the loop is
// shared.
//
// Nibble slots (packed8) have a kernel of their own that counts a whole
// word at a time, bit-sliced: slot by slot, eight nibbles cost some 56
// integer ops per 4-byte word, which put the kernel on the integer
// issue rate rather than on memory.  The word's bit planes (x, x >> 1,
// x >> 2, with bit 0 of each nibble as its field) give, under the mask
// of nibbles below 8 (bit 3 clear: pad 15 and values 8-15 fall out
// there), the four masks of the low two bits, q0..q3.  s[q] += q-mask
// counts values q and q + 4 together, h[q] += q-mask & bit 2 counts
// q + 4 alone; each add raises a nibble field by at most one, so the
// accumulators hold 15 rows (kNibbleFlush) before their eight fields
// are summed into the int32 counts (v = q: s - h, v = q + 4: h).  About
// 20 ops a word in place of 56.
//
// cp.async/TMA staging and tuning are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns per CTA

struct Packed4 {  // four byte-slots per int32 row
  using Row = uint32_t;
  static constexpr int kSlots = 4;
  static constexpr int kFlush = 63;  // 4 * 63 = 252 <= 255
  __device__ static uint32_t slot(Row x, int k) {
    return (x >> (8 * k)) & 0xFFu;
  }
};

struct Bytes {  // one byte-slot per row
  using Row = uint8_t;
  static constexpr int kSlots = 1;
  static constexpr int kFlush = 255;
  __device__ static uint32_t slot(Row x, int) { return x; }
};

template <typename D>
__global__ void __launch_bounds__(kThreads)
lanes_vote_kernel(const typename D::Row* __restrict__ vb,
                  const int64_t* __restrict__ tile_row_start,
                  int32_t* __restrict__ out, int64_t n_tiles, int tile_w,
                  int groups) {
  const int64_t tile = blockIdx.x / groups;
  const int col = (blockIdx.x % groups) * kThreads + threadIdx.x;
  const int64_t r_begin = tile_row_start[tile];
  const int64_t r_end = tile_row_start[tile + 1];

  uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0, c6 = 0, c7 = 0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += D::kFlush) {
    const int64_t r1 = r0 + D::kFlush < r_end ? r0 + D::kFlush : r_end;
    const typename D::Row* p = vb + r0 * tile_w + col;
    uint32_t lo = 0, hi = 0;
#pragma unroll 4
    for (int64_t r = r0; r < r1; ++r, p += tile_w) {
      const typename D::Row x = __ldg(p);
#pragma unroll
      for (int k = 0; k < D::kSlots; ++k) {
        const uint32_t v = D::slot(x, k);
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

constexpr uint32_t kNibbleLow = 0x11111111u;  // bit 0 of each nibble
constexpr int kNibbleFlush = 15;  // a 4-bit field holds 15 rows

// Sum of the eight 4-bit fields of a (each at most 15).
__device__ __forceinline__ uint32_t nibble_sum(uint32_t a) {
  const uint32_t b = (a & 0x0F0F0F0Fu) + ((a >> 4) & 0x0F0F0F0Fu);
  return (b * 0x01010101u) >> 24;  // four byte fields of at most 30
}

__global__ void __launch_bounds__(kThreads)
lanes_vote_packed8_kernel(const uint32_t* __restrict__ vb,
                          const int64_t* __restrict__ tile_row_start,
                          int32_t* __restrict__ out, int64_t n_tiles,
                          int tile_w, int groups) {
  const int64_t tile = blockIdx.x / groups;
  const int col = (blockIdx.x % groups) * kThreads + threadIdx.x;
  const int64_t r_begin = tile_row_start[tile];
  const int64_t r_end = tile_row_start[tile + 1];

  uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0, c6 = 0, c7 = 0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kNibbleFlush) {
    const int64_t r1 = r0 + kNibbleFlush < r_end ? r0 + kNibbleFlush : r_end;
    const uint32_t* p = vb + r0 * tile_w + col;
    uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0, h0 = 0, h1 = 0, h2 = 0, h3 = 0;
#pragma unroll 5
    for (int64_t r = r0; r < r1; ++r, p += tile_w) {
      const uint32_t x = __ldg(p);
      const uint32_t ok = ~(x >> 3) & kNibbleLow;  // nibble < 8
      const uint32_t b1 = x >> 1, b2 = x >> 2;
      const uint32_t q0 = ~x & ~b1 & ok, q1 = x & ~b1 & ok;
      const uint32_t q2 = ~x & b1 & ok, q3 = x & b1 & ok;
      s0 += q0;
      s1 += q1;
      s2 += q2;
      s3 += q3;
      h0 += q0 & b2;
      h1 += q1 & b2;
      h2 += q2 & b2;
      h3 += q3 & b2;
    }
    const uint32_t e4 = nibble_sum(h0), e5 = nibble_sum(h1);
    const uint32_t e6 = nibble_sum(h2), e7 = nibble_sum(h3);
    c0 += nibble_sum(s0) - e4;
    c1 += nibble_sum(s1) - e5;
    c2 += nibble_sum(s2) - e6;
    c3 += nibble_sum(s3) - e7;
    c4 += e4;
    c5 += e5;
    c6 += e6;
    c7 += e7;
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

template <typename Row>
int launch(void (*kernel)(const Row*, const int64_t*, int32_t*, int64_t,
                          int, int),
           const void* vb, const void* tile_row_start, void* out,
           int64_t n_tiles, int tile_w, void* stream) {
  if (n_tiles <= 0 || tile_w <= 0 || tile_w % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  const int groups = tile_w / kThreads;
  const int64_t grid = n_tiles * groups;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const Row*)vb, (const int64_t*)tile_row_start, (int32_t*)out, n_tiles,
      tile_w, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// vb: (n_rows, tile_w) rows of the entry point's layout (int32 packed4,
// uint8/int8 bytes, int32 packed8); tile_row_start: int64 (n_tiles + 1),
// non-decreasing, in rows of that layout, last entry <= n_rows; out:
// int32 (8, n_tiles*tile_w).  Each launches on `stream` and returns
// cudaGetLastError().
extern "C" int lanes_vote_packed4(const void* vb, const void* tile_row_start,
                                  void* out, int64_t n_tiles, int tile_w,
                                  void* stream) {
  return launch(lanes_vote_kernel<Packed4>, vb, tile_row_start, out, n_tiles,
                tile_w, stream);
}

extern "C" int lanes_vote_bytes(const void* vb, const void* tile_row_start,
                                void* out, int64_t n_tiles, int tile_w,
                                void* stream) {
  return launch(lanes_vote_kernel<Bytes>, vb, tile_row_start, out, n_tiles,
                tile_w, stream);
}

extern "C" int lanes_vote_packed8(const void* vb, const void* tile_row_start,
                                  void* out, int64_t n_tiles, int tile_w,
                                  void* stream) {
  return launch(lanes_vote_packed8_kernel, vb, tile_row_start, out, n_tiles,
                tile_w, stream);
}
