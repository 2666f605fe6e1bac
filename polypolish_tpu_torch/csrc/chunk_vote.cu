// Chunk vote kernel: dense pileup counts from the chunk layout.
//
// Replaces the three TPU kernels of polypolish_tpu/ops/vote_pallas.py
// (launched by _vote_pallas_call): _make_vote_kernel_split ("split"),
// _make_vote_kernel_fused ("fused") and _make_vote_kernel ("unfused",
// with chunks_per_step).  They are three ways of laying one function
// onto the TPU's matrix unit as one-hot matmuls; they read the same
// chunk layout and write the same counts, and only that contract
// carries over.
//
// Contract.  A chunk is e_sub * 128 events of one tile of tile_p
// positions: pos[e] is the tile-local position, vocab[e] the vocab id,
// chunk_tile[c] the tile.  Chunks come tiles in order (the packers'
// layout; the TPU kernels zero a tile on its first chunk and rely on it
// too), so tile t owns the chunks [plan[t], plan[t + 1]) of a prefix
// that the launch builds from chunk_tile; chunks of tiles outside
// [0, n_tiles) count nothing.  A chunk_tile that decreases anywhere sets
// a flag (plan[n_tiles + 1]) and nothing is counted: the wrapper reads it
// and raises.  out[v, t*tile_p + pos] (int32, 8 rows of n_tiles*tile_p)
// = number of tile t's events with that (v, pos); every element is
// written, so the output needs no zero-fill, and a tile with no chunk
// gets zeros.  Events with pos outside [0, tile_p) or vocab outside
// [0, 8) count nothing, which covers both pad conventions: int32 with
// pos -1 (prepare_chunks) and uint8 with vocab 255 (pp_chunks_from_runs).
//
// What bounds it on an H100: bytes.  Each event is read once (2 or 8
// bytes; in the int32 layout the vocab of pad events need not be read)
// and the (8, n_tiles*tile_p) output written once; the work per event
// is one shared-memory atomic.
//
// Design.  Three launches on the stream.  (1) chunk_plan_kernel: one
// pass over chunk_tile writes the prefix and the order flag.
// (2) chunk_vote_kernel, one CTA per tile: it builds the tile's
// 8 x tile_p int32 histogram in dynamic shared memory (32 * tile_p
// bytes; past the 48 KB default at tile_p 2048, so the launch opts in)
// from the tile's chunks, read as 16-byte vectors of pos and vocab,
// kBatch vectors of each in flight per thread, then writes each of its
// 8 * tile_p outputs once with coalesced 16-byte stores: no global
// atomics and no zero-fill pass.  A thread's 16 (uint8) or 4 (int32)
// events of one vector are consecutive events of one read, at nearby
// positions, so they fall in one thread and not on one warp's atomic;
// the warp's lanes hit positions 16 (or 4) apart, which would share a
// bank two lanes in sixteen, so the histogram's columns are swizzled
// (bits 0-4 XOR bits 5-9) to spread them over the banks.  (3) A tile
// deeper than kSegEvents events would leave one CTA working long after
// the rest: the packers round the chunk count up (to a 32,768-chunk
// slab multiple past one slab) with pad chunks on the last tile, some
// 31,600 of them at E. coli 50x, and repeat copies pile reads up.  So
// the per-tile CTA takes only a tile's first kSegEvents events, and
// chunk_vote_deep_kernel takes the rest in segments of as many, one CTA
// each, adding their non-zero bins to the tile's output with global
// atomics (only on such tiles).  Integer sums are order-free, so the
// result is bitwise deterministic.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 8;     // dense vocab rows
constexpr int kLane = 128;    // events per chunk row
constexpr int kThreads = 256;
constexpr int kMaxTileP = 2048;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSegEvents = 32768;  // events per CTA; deeper tiles split
constexpr int kPlanThreads = 256;

// Histogram column of tile-local position p: XOR of bits 0-4 with bits
// 5-9 (a permutation of every 32-aligned run, so it stays in the row).
__device__ __forceinline__ int swizzle(int p) { return p ^ ((p >> 5) & 31); }

__device__ __forceinline__ void count(int32_t* hist, int tile_p, uint32_t p,
                                      uint32_t v) {
  // unsigned compares drop negative pads too
  if (p < (uint32_t)tile_p && v < (uint32_t)kVocab)
    atomicAdd(&hist[v * tile_p + swizzle((int)p)], 1);
}

template <typename T>
struct Vec;

// Per layout: events per 16-byte vector, vectors of each array in flight
// per thread, and whether a vector's vocab is read only when one of its
// positions counts (int32: pad is pos -1, so the vocab of an all-pad
// vector is never needed, and a sparse stream's chunks are nearly all
// pad; uint8 marks pad in vocab, so both arrays are read together).
template <>
struct Vec<uint8_t> {  // 16 events per 16-byte vector
  static constexpr int kBatch = 4;
  static constexpr int kMinBlocks = 5;
  static constexpr bool kVocabOnDemand = false;
  __device__ static void count_all(int32_t* hist, int tile_p, uint4 p,
                                   uint4 v) {
    const uint32_t pw[4] = {p.x, p.y, p.z, p.w};
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        count(hist, tile_p, (pw[w] >> (8 * k)) & 0xFFu,
              (vw[w] >> (8 * k)) & 0xFFu);
  }
};

template <>
struct Vec<int32_t> {  // 4 events per 16-byte vector
  static constexpr int kBatch = 2;
  static constexpr int kMinBlocks = 7;
  static constexpr bool kVocabOnDemand = true;
  __device__ static bool any_pos(uint4 p, int tile_p) {
    const uint32_t t = (uint32_t)tile_p;
    return (p.x < t) | (p.y < t) | (p.z < t) | (p.w < t);
  }
  __device__ static void count_all(int32_t* hist, int tile_p, uint4 p,
                                   uint4 v) {
    count(hist, tile_p, p.x, v.x);
    count(hist, tile_p, p.y, v.y);
    count(hist, tile_p, p.z, v.z);
    count(hist, tile_p, p.w, v.w);
  }
};

__device__ __forceinline__ void zero_hist(int4* smem, int quads) {
  for (int i = threadIdx.x; i < quads; i += kThreads)
    smem[i] = make_int4(0, 0, 0, 0);
}

// Add chunks [c0, c1) to the shared histogram, kBatch 16-byte vectors of
// pos and vocab in flight per thread (vocab after pos, where needed, in
// the int32 layout).
template <typename T>
__device__ __forceinline__ void count_chunks(int32_t* hist, int tile_p,
                                             const uint4* __restrict__ pos,
                                             const uint4* __restrict__ vocab,
                                             int64_t c0, int64_t c1,
                                             int64_t chunk_vecs) {
  constexpr int kBatch = Vec<T>::kBatch;
  const uint4* p_vec = pos + c0 * chunk_vecs;
  const uint4* v_vec = vocab + c0 * chunk_vecs;
  const int64_t n = (c1 - c0) * chunk_vecs;
  for (int64_t i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    uint4 p[kBatch], v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t i = i0 + (int64_t)b * kThreads;
      p[b] = i < n ? __ldg(p_vec + i) : make_uint4(0, 0, 0, 0);
      if constexpr (!Vec<T>::kVocabOnDemand)
        v[b] = i < n ? __ldg(v_vec + i) : make_uint4(0, 0, 0, 0);
    }
    if constexpr (Vec<T>::kVocabOnDemand) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t i = i0 + (int64_t)b * kThreads;
        v[b] = i < n && Vec<T>::any_pos(p[b], tile_p) ? __ldg(v_vec + i)
                                                       : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i0 + (int64_t)b * kThreads < n)
        Vec<T>::count_all(hist, tile_p, p[b], v[b]);
  }
}

// plan[t] for t <= n_tiles: the first chunk whose tile is >= t (tile t
// owns chunks [plan[t], plan[t + 1])); plan[n_tiles + 1] (zeroed before
// the launch) is set to 1 if chunk_tile ever decreases.  Chunk c starts
// the tiles in (chunk_tile[c - 1], chunk_tile[c]], so in a
// non-decreasing map every entry is written exactly once.
__global__ void __launch_bounds__(kPlanThreads)
chunk_plan_kernel(const int32_t* __restrict__ chunk_tile, int64_t n_chunks,
                  int64_t n_tiles, int64_t* __restrict__ plan) {
  const int64_t stride = (int64_t)gridDim.x * kPlanThreads;
  for (int64_t c = (int64_t)blockIdx.x * kPlanThreads + threadIdx.x;
       c <= n_chunks; c += stride) {
    int64_t lo = c > 0 ? (int64_t)chunk_tile[c - 1] + 1 : 0;
    int64_t hi = c < n_chunks ? (int64_t)chunk_tile[c] : n_tiles;
    if (c > 0 && c < n_chunks && hi < lo - 1) {
      plan[n_tiles + 1] = 1;
      continue;
    }
    lo = lo < 0 ? 0 : lo;
    hi = hi > n_tiles ? n_tiles : hi;
    for (int64_t t = lo; t <= hi; ++t) plan[t] = c;
  }
}

// The chunks [c0, c1) of a tile, clamped into [0, n_chunks).
__device__ __forceinline__ void tile_chunks(const int64_t* __restrict__ plan,
                                            int64_t tile, int64_t n_chunks,
                                            int64_t& c0, int64_t& c1) {
  const int64_t s0 = plan[tile], s1 = plan[tile + 1];
  c0 = s0 < 0 ? 0 : (s0 > n_chunks ? n_chunks : s0);
  c1 = s1 < c0 ? c0 : (s1 > n_chunks ? n_chunks : s1);
}

// One CTA per tile: its first seg_chunks chunks (all of them, unless the
// tile is deeper), then every output element of the tile once, with
// plain 16-byte stores.
template <typename T>
__global__ void __launch_bounds__(kThreads, Vec<T>::kMinBlocks)
chunk_vote_kernel(const uint4* __restrict__ pos, const uint4* __restrict__ vocab,
                  const int64_t* __restrict__ plan, int64_t n_chunks,
                  int32_t* __restrict__ out, int64_t n_tiles, int tile_p,
                  int64_t chunk_vecs, int64_t seg_chunks) {
  if (plan[n_tiles + 1] != 0) return;  // tiles out of order: refused
  extern __shared__ int4 smem[];  // [kVocab][tile_p] int32, swizzled
  int32_t* hist = reinterpret_cast<int32_t*>(smem);
  const int quads = kVocab * tile_p / 4;
  const int64_t tile = blockIdx.x;
  zero_hist(smem, quads);
  int64_t c0, c1;
  tile_chunks(plan, tile, n_chunks, c0, c1);
  if (c1 - c0 > seg_chunks) c1 = c0 + seg_chunks;
  __syncthreads();
  count_chunks<T>(hist, tile_p, pos, vocab, c0, c1, chunk_vecs);
  __syncthreads();

  const int64_t width = n_tiles * tile_p;
  for (int i = threadIdx.x; i < quads; i += kThreads) {
    const int row = 4 * i / tile_p;
    const int col = 4 * i - row * tile_p;
    const int32_t* h = hist + row * tile_p;
    *reinterpret_cast<int4*>(out + row * width + tile * tile_p + col) =
        make_int4(h[swizzle(col)], h[swizzle(col + 1)], h[swizzle(col + 2)],
                  h[swizzle(col + 3)]);
  }
}

// The rest of the tiles deeper than seg_chunks, launched after
// chunk_vote_kernel: CTA k takes the chunks of [k, k + 1) * seg_chunks
// past their tile's first seg_chunks.  All such chunks belong to the
// tile of chunk k * seg_chunks (a tile that starts later in the range
// has no chunk past its first seg_chunks there), and their non-zero bins
// are added to the tile's output with global atomics.
template <typename T>
__global__ void __launch_bounds__(kThreads, Vec<T>::kMinBlocks)
chunk_vote_deep_kernel(const uint4* __restrict__ pos,
                       const uint4* __restrict__ vocab,
                       const int32_t* __restrict__ chunk_tile,
                       const int64_t* __restrict__ plan, int64_t n_chunks,
                       int32_t* __restrict__ out, int64_t n_tiles,
                       int tile_p, int64_t chunk_vecs, int64_t seg_chunks) {
  if (plan[n_tiles + 1] != 0) return;
  const int64_t k0 = (int64_t)blockIdx.x * seg_chunks;
  const int64_t tile = chunk_tile[k0];
  if (tile < 0 || tile >= n_tiles) return;
  int64_t c0, c1;
  tile_chunks(plan, tile, n_chunks, c0, c1);
  c0 = c0 + seg_chunks > k0 ? c0 + seg_chunks : k0;
  c1 = c1 < k0 + seg_chunks ? c1 : k0 + seg_chunks;
  if (c0 >= c1) return;  // the same for the whole CTA

  extern __shared__ int4 smem[];
  int32_t* hist = reinterpret_cast<int32_t*>(smem);
  const int bins = kVocab * tile_p;
  zero_hist(smem, bins / 4);
  __syncthreads();
  count_chunks<T>(hist, tile_p, pos, vocab, c0, c1, chunk_vecs);
  __syncthreads();
  const int64_t width = n_tiles * tile_p;
  for (int i = threadIdx.x; i < bins; i += kThreads) {
    const int row = i / tile_p;
    const int col = i - row * tile_p;
    const int32_t c = hist[row * tile_p + swizzle(col)];
    if (c != 0) atomicAdd(&out[row * width + tile * tile_p + col], c);
  }
}

template <typename T>
int launch(const void* pos, const void* vocab, const void* chunk_tile,
           int64_t n_chunks, void* plan, void* out, int64_t n_tiles,
           int tile_p, int e_sub, void* stream) {
  if (n_chunks < 0 || n_tiles <= 0 || n_tiles > 0x7FFFFFFF || tile_p <= 0 ||
      tile_p % kLane != 0 || tile_p > kMaxTileP || e_sub <= 0 ||
      ((uintptr_t)pos | (uintptr_t)vocab | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t chunk_events = (int64_t)e_sub * kLane;
  const int64_t chunk_vecs = chunk_events * (int64_t)sizeof(T) / 16;
  const int64_t seg_chunks =
      chunk_events >= kSegEvents ? 1 : kSegEvents / chunk_events;
  const size_t smem = sizeof(int32_t) * kVocab * (size_t)tile_p;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_vote_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunk_vote_deep_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t deep_blocks = (n_chunks + seg_chunks - 1) / seg_chunks;
  if (deep_blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int64_t* p = (int64_t*)plan;
  cudaError_t err = cudaMemsetAsync(p + n_tiles + 1, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t plan_blocks = n_chunks / kPlanThreads + 1;  // n_chunks + 1
  chunk_plan_kernel<<<(unsigned)(plan_blocks < 65536 ? plan_blocks : 65536),
                      kPlanThreads, 0, s>>>((const int32_t*)chunk_tile,
                                            n_chunks, n_tiles, p);
  chunk_vote_kernel<T><<<(unsigned)n_tiles, kThreads, smem, s>>>(
      (const uint4*)pos, (const uint4*)vocab, p, n_chunks, (int32_t*)out,
      n_tiles, tile_p, chunk_vecs, seg_chunks);
  if (n_chunks > seg_chunks)
    chunk_vote_deep_kernel<T><<<(unsigned)deep_blocks, kThreads, smem, s>>>(
        (const uint4*)pos, (const uint4*)vocab, (const int32_t*)chunk_tile, p,
        n_chunks, (int32_t*)out, n_tiles, tile_p, chunk_vecs, seg_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// pos, vocab: (n_chunks * e_sub * 128,) of int32 or uint8, 16-byte
// aligned; chunk_tile: int32 (n_chunks,); plan: int64 (n_tiles + 2)
// scratch, which returns the tile prefix in [0, n_tiles] and, in
// [n_tiles + 1], 1 if chunk_tile is not non-decreasing (then out is not
// written); out: int32 (8, n_tiles * tile_p), 16-byte aligned; tile_p a
// multiple of 128 up to 2048.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int chunk_vote_i32(const void* pos, const void* vocab,
                              const void* chunk_tile, int64_t n_chunks,
                              void* plan, void* out, int64_t n_tiles,
                              int tile_p, int e_sub, void* stream) {
  return launch<int32_t>(pos, vocab, chunk_tile, n_chunks, plan, out,
                         n_tiles, tile_p, e_sub, stream);
}

extern "C" int chunk_vote_u8(const void* pos, const void* vocab,
                             const void* chunk_tile, int64_t n_chunks,
                             void* plan, void* out, int64_t n_tiles,
                             int tile_p, int e_sub, void* stream) {
  return launch<uint8_t>(pos, vocab, chunk_tile, n_chunks, plan, out,
                         n_tiles, tile_p, e_sub, stream);
}
