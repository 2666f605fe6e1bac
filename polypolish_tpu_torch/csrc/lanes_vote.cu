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
// has to stay below what the card can issue while memory streams it
// (some 64 int32 operations per SM and clock against about 13 bytes).
//
// Byte layouts (packed4, bytes): two launches over a split of the rows.
//
// Work split.  The packers put every pad block on the last tile (up to
// an eighth of the blocks after geometric rounding, more past a slab),
// and repeat copies make deep tiles; one CTA walking all of a tile's
// rows left the last tile's CTAs reading thousands of rows alone (37.5%
// of the bound on a mesh pack with 207 pad blocks).  So no CTA reads
// more than kSegRows rows of one tile (32 int32 rows, 128 byte rows:
// the shortest that leaves the capped E. coli pack's tiles whole but its
// last).  (1) lanes_first_kernel, one CTA per (tile, column group),
// takes each tile's first kSegRows rows and writes all of the tile's
// outputs with plain stores: no zero-fill, and a tile with no rows gets
// zeros.  (2) lanes_deep_kernel cuts the rows into global segments
// [k, k + 1) * kSegRows and takes, per (segment, column group), the
// rows past their tile's first kSegRows: all such rows of a segment
// belong to the tile holding its first row (a tile starting later in
// the segment has none past its first kSegRows there), found by a
// 128-way search of tile_row_start.  It adds its non-zero counts with
// global atomics, so a pad segment costs its reads and no atomic;
// integer sums are order-free and the result is bitwise deterministic.
// The entry point gets only the device-resident tile_row_start, so
// launch 2 is a persistent grid (as many CTAs as fit on the card) that
// reads the row count there and walks the segments from the last one
// back (the pad's first); on a pack with no deep tile each CTA looks up
// a few segments and finds nothing to do.  Launch 2 is a programmatic
// dependent launch: its CTAs start on the SMs that launch 1's last wave
// leaves idle, search and read while launch 1 finishes, and wait for
// it (griddepcontrol.wait) only before their first atomic.
// tests/test_torch_vote_lanes.py holds a plain model of this split.
//
// Counting.  A thread owns one 16-byte piece of each row: 4 int32
// columns of four byte slots (packed4) or 16 byte columns (bytes), read
// as one uint4, kBatch rows in flight.  Each 32-bit word is counted a
// byte field at a time, bit-sliced as the packed8 kernel counts
// nibbles: with ok the mask of bytes below 8 (bit 0 of each byte) and
// b1, b2 the word shifted by 1 and 2, the four masks q0..q3 of a byte's
// two low bits give s[q] += q (values q and q + 4) and h[q] += q & b2
// (value q + 4).  Some 19 integer ops per word, where one slot at a
// time took about 40, which had held this kernel on the integer issue
// rate.  Each row adds at most one to a byte field, so a segment of
// kSegRows <= 255 rows needs no flush: its fields are summed into the
// counts once, at the end (packed4: a column's count is the sum of its
// word's four fields; bytes: each field is a column's count).
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): packed4 at 79% of
// its byte bound on the capped, padded and mesh E. coli packs, where
// the one-CTA-per-tile design reached 66%, 17% (tools/lanes_vote_sweep.py
// on the padded shape) and 37.5%; bytes at 62%.  What is left: launch
// 1's last partial wave and the serial row walk of a deep segment.

// Nibble slots (packed8) have a kernel of their own that counts a whole
// word at a time, bit-sliced: under the mask of nibbles below 8 (bit 3
// clear: pad 15 and values 8-15 fall out there) the four masks of the
// low two bits, q0..q3, give s[q] += q-mask (values q and q + 4) and
// h[q] += q-mask & bit 2 (q + 4 alone); each add raises a nibble field
// by at most one, so the accumulators hold 15 rows (kNibbleFlush) before
// their eight fields are summed into the int32 counts (v = q: s - h,
// v = q + 4: h).  It keeps one CTA per (tile, 128 columns) walking all
// of the tile's rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr uint32_t kByteLow = 0x01010101u;  // bit 0 of each byte
constexpr int kBatch = 4;  // rows in flight per thread
constexpr int kMaxDevices = 64;

// Sum of the four byte fields of a.
__device__ __forceinline__ uint32_t byte_sum(uint32_t a) {
  const uint32_t b = (a & 0x00FF00FFu) + ((a >> 8) & 0x00FF00FFu);
  return (b & 0xFFFFu) + (b >> 16);
}

struct Packed4 {  // a uint4 is 4 int32 columns, each four byte slots
  static constexpr int kCols = 4;
  // rows per segment (a CTA's share of one tile), at most 255 so that no
  // byte field overflows
  static constexpr int kSegRows = 32;
  // count of column i from the four words' fields of one value
  __device__ static uint32_t count(const uint32_t (&a)[4], int i) {
    return byte_sum(a[i]);
  }
};

struct Bytes {  // a uint4 is 16 byte columns, one slot each
  static constexpr int kCols = 16;
  static constexpr int kSegRows = 128;
  __device__ static uint32_t count(const uint32_t (&a)[4], int i) {
    return (a[i >> 2] >> (8 * (i & 3))) & 0xFFu;
  }
};

// Count the four byte slots of word x into its planes (see Counting).
__device__ __forceinline__ void add_word(uint32_t x, uint32_t (&s)[4],
                                         uint32_t (&h)[4]) {
  // bit 5 of each byte of big: byte >> 3 is not 0 (no carry between
  // bytes: 31 + 31 < 64)
  const uint32_t big = ((x >> 3) & 0x1F1F1F1Fu) + 0x1F1F1F1Fu;
  const uint32_t ok = ~(big >> 5) & kByteLow;  // byte < 8
  const uint32_t b1 = x >> 1, b2 = x >> 2;
  const uint32_t q0 = ~x & ~b1 & ok, q1 = x & ~b1 & ok;
  const uint32_t q2 = ~x & b1 & ok, q3 = x & b1 & ok;
  s[0] += q0;
  s[1] += q1;
  s[2] += q2;
  s[3] += q3;
  h[0] += q0 & b2;
  h[1] += q1 & b2;
  h[2] += q2 & b2;
  h[3] += q3 & b2;
}

__device__ __forceinline__ void add_piece(const uint4& x, uint32_t (&s)[4][4],
                                          uint32_t (&h)[4][4]) {
  add_word(x.x, s[0], h[0]);
  add_word(x.y, s[1], h[1]);
  add_word(x.z, s[2], h[2]);
  add_word(x.w, s[3], h[3]);
}

// Planes of n rows (n <= 255) of one thread's pieces, `stride` uint4
// apart, kBatch loads in flight.
__device__ __forceinline__ void count_rows(const uint4* __restrict__ p,
                                           int64_t stride, int n,
                                           uint32_t (&s)[4][4],
                                           uint32_t (&h)[4][4]) {
  int r = 0;
  for (; r + kBatch <= n; r += kBatch, p += kBatch * stride) {
    uint4 x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = __ldcs(p + k * stride);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) add_piece(x[k], s, h);
  }
  for (; r < n; ++r, p += stride) add_piece(__ldcs(p), s, h);
}

// Write (kAdd false) or add (kAdd true, non-zero counts only) the
// thread's 8 x kCols counts at o[v * width + i].
template <typename D, bool kAdd>
__device__ __forceinline__ void emit(const uint32_t (&s)[4][4],
                                     const uint32_t (&h)[4][4], int32_t* o,
                                     int64_t width) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int q = v & 3;
    uint32_t a[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] = v < 4 ? s[w][q] - h[w][q] : h[w][q];
    int32_t* ov = o + v * width;
#pragma unroll
    for (int i = 0; i < D::kCols; i += 4) {
      const int4 c = make_int4((int)D::count(a, i), (int)D::count(a, i + 1),
                               (int)D::count(a, i + 2),
                               (int)D::count(a, i + 3));
      if (kAdd) {
        if (c.x) atomicAdd(ov + i, c.x);
        if (c.y) atomicAdd(ov + i + 1, c.y);
        if (c.z) atomicAdd(ov + i + 2, c.z);
        if (c.w) atomicAdd(ov + i + 3, c.w);
      } else {
        *reinterpret_cast<int4*>(ov + i) = c;
      }
    }
  }
}

// Launch 1: CTA (tile, g) counts the tile's first kSegRows rows in its
// column group and stores all of their counts.
template <typename D>
__global__ void __launch_bounds__(kThreads)
lanes_first_kernel(const uint4* __restrict__ vb,
                   const int64_t* __restrict__ tile_row_start,
                   int32_t* __restrict__ out, int64_t n_tiles, int tile_w,
                   int groups) {
  // launch 2 may start once every CTA of this grid has: its CTAs then
  // fill the SMs that this grid's last wave leaves idle
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t tile = blockIdx.x / groups;
  const int col = ((int)(blockIdx.x % groups) * kThreads + threadIdx.x) *
                  D::kCols;
  if (col >= tile_w) return;
  const int64_t b = tile_row_start[tile];
  const int64_t end = tile_row_start[tile + 1];
  const int n = (int)(end - b < D::kSegRows ? end - b : D::kSegRows);
  const int64_t stride = tile_w / D::kCols;  // uint4 per row
  uint32_t s[4][4] = {}, h[4][4] = {};
  count_rows(vb + b * stride + col / D::kCols, stride, n, s, h);
  emit<D, false>(s, h, out + tile * tile_w + col, n_tiles * tile_w);
}

// Launch 2 (persistent): item k = (segment k / groups, group k % groups)
// counts the rows of segment [seg, seg + 1) * kSegRows past the first
// kSegRows of the tile that holds the segment's first row, and adds them.
template <typename D>
__global__ void __launch_bounds__(kThreads)
lanes_deep_kernel(const uint4* __restrict__ vb,
                  const int64_t* __restrict__ tile_row_start,
                  int32_t* __restrict__ out, int64_t n_tiles, int tile_w,
                  int groups) {
  const int64_t n_rows = tile_row_start[n_tiles];
  const int64_t n_items =
      (n_rows + D::kSegRows - 1) / D::kSegRows * (int64_t)groups;
  const int64_t stride = tile_w / D::kCols;
  // from the last row back: the packers put every pad block on the last
  // tile, so its segments come first, while launch 1 still runs
  for (int64_t k = blockIdx.x; k < n_items; k += gridDim.x) {
    const int64_t item = n_items - 1 - k;
    const int64_t row0 = item / groups * D::kSegRows;
    if (tile_row_start[0] > row0) continue;  // rows before the first tile
    // the last tile t with tile_row_start[t] <= row0, 128 ways a round:
    // the probes are non-decreasing, so the threads that pass are a
    // prefix, and their count picks the sub-range
    int64_t lo = 0, hi = n_tiles;
    while (hi - lo > 1) {
      const int64_t step = (hi - lo + kThreads - 1) / kThreads;
      const int64_t probe = lo + (int64_t)threadIdx.x * step;
      const int below = __syncthreads_count(
          probe < hi && tile_row_start[probe] <= row0);
      lo += (int64_t)(below - 1) * step;
      hi = hi < lo + step ? hi : lo + step;
    }
    const int64_t first_end = tile_row_start[lo] + D::kSegRows;
    const int64_t tile_end = tile_row_start[lo + 1];
    const int64_t b = row0 > first_end ? row0 : first_end;
    const int64_t e =
        row0 + D::kSegRows < tile_end ? row0 + D::kSegRows : tile_end;
    const int col = ((int)(item % groups) * kThreads + threadIdx.x) *
                    D::kCols;
    if (b >= e || col >= tile_w) continue;
    uint32_t s[4][4] = {}, h[4][4] = {};
    count_rows(vb + b * stride + col / D::kCols, stride, (int)(e - b), s, h);
    // launch 1's stores must land before these adds
    asm volatile("griddepcontrol.wait;" ::: "memory");
    emit<D, true>(s, h, out + lo * tile_w + col, n_tiles * tile_w);
  }
  // and this grid ends after launch 1, so that what follows it on the
  // stream finds the whole output written
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// CTAs of launch 2 on the current device: as many as fit at once.
template <typename D>
cudaError_t deep_grid(int* grid) {
  static int cached[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *grid = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lanes_deep_kernel<D>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *grid;
  return cudaSuccess;
}

template <typename D>
int launch_split(const void* vb, const void* tile_row_start, void* out,
                 int64_t n_tiles, int tile_w, void* stream) {
  static_assert(0 < D::kSegRows && D::kSegRows <= 255,
                "a byte field holds 255 rows");
  if (n_tiles <= 0 || tile_w <= 0 || tile_w % kThreads != 0 ||
      ((uintptr_t)vb | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int groups = (tile_w / D::kCols + kThreads - 1) / kThreads;
  const int64_t grid = n_tiles * groups;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int deep = 0;
  const cudaError_t err = deep_grid<D>(&deep);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  lanes_first_kernel<D><<<(unsigned)grid, kThreads, 0, s>>>(
      (const uint4*)vb, (const int64_t*)tile_row_start, (int32_t*)out,
      n_tiles, tile_w, groups);
  // programmatic dependent launch: launch 2 looks up its segments and
  // reads its rows while launch 1 finishes, and waits for it
  // (griddepcontrol.wait) only before its first atomic
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)deep);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, lanes_deep_kernel<D>, (const uint4*)vb,
      (const int64_t*)tile_row_start, (int32_t*)out, n_tiles, tile_w, groups);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
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

int launch_packed8(const void* vb, const void* tile_row_start, void* out,
                   int64_t n_tiles, int tile_w, void* stream) {
  if (n_tiles <= 0 || tile_w <= 0 || tile_w % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  const int groups = tile_w / kThreads;
  const int64_t grid = n_tiles * groups;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  lanes_vote_packed8_kernel<<<(unsigned)grid, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)vb, (const int64_t*)tile_row_start, (int32_t*)out,
      n_tiles, tile_w, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// vb: (n_rows, tile_w) rows of the entry point's layout (int32 packed4,
// uint8/int8 bytes, int32 packed8; 16-byte aligned for packed4 and
// bytes); tile_row_start: int64 (n_tiles + 1), non-decreasing, in rows
// of that layout, last entry <= n_rows; out: int32 (8, n_tiles*tile_w),
// 16-byte aligned for packed4 and bytes; tile_w a multiple of 128.  Each
// launches on `stream` (packed4 and bytes: two kernels, in order) and
// returns cudaGetLastError().
extern "C" int lanes_vote_packed4(const void* vb, const void* tile_row_start,
                                  void* out, int64_t n_tiles, int tile_w,
                                  void* stream) {
  return launch_split<Packed4>(vb, tile_row_start, out, n_tiles, tile_w,
                               stream);
}

extern "C" int lanes_vote_bytes(const void* vb, const void* tile_row_start,
                                void* out, int64_t n_tiles, int tile_w,
                                void* stream) {
  return launch_split<Bytes>(vb, tile_row_start, out, n_tiles, tile_w,
                             stream);
}

extern "C" int lanes_vote_packed8(const void* vb, const void* tile_row_start,
                                  void* out, int64_t n_tiles, int tile_w,
                                  void* stream) {
  return launch_packed8(vb, tile_row_start, out, n_tiles, tile_w, stream);
}
