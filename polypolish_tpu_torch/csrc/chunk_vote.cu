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
// chunk_tile[c] the tile.  out[v, tile*tile_p + pos] (int32, 8 rows of
// n_tiles*tile_p, zero-filled by the caller) += number of events with
// that (v, pos).  Events with pos outside [0, tile_p) or vocab outside
// [0, 8) count nothing, which covers both pad conventions: int32 with
// pos -1 (prepare_chunks) and uint8 with vocab 255 (pp_chunks_from_runs).
// Chunks whose tile lies outside [0, n_tiles) count nothing.  With
// chunks_per_cta = k > 1 (the TPU's chunks_per_step) the k chunks of a
// CTA must share one tile; the wrapper checks it.
//
// What bounds it on an H100: bytes.  Each chunk is read once (2 or 8
// bytes per event) and the (8, n_tiles*tile_p) output written once; the
// work per event is one shared-memory atomic.
//
// Design.  One CTA per k chunks builds an 8 x tile_p int32 histogram in
// dynamic shared memory (32 * tile_p bytes: 8 KB at tile_p 256, 64 KB at
// 2048, past the 48 KB default, so the launch opts in with
// cudaFuncSetAttribute) with shared-memory atomics, then adds its
// non-zero bins to the output with global integer atomicAdd.  Integer
// atomics are exact and order-free, so the result is bitwise
// deterministic however the CTAs are scheduled; most bins of a sparse
// chunk are zero and cost no global traffic.  k > 1 amortises the
// histogram's zero-fill and flush over k chunks.  Tuning is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 8;     // dense vocab rows
constexpr int kLane = 128;    // events per chunk row
constexpr int kThreads = 256;
constexpr int kMaxTileP = 2048;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_vote_kernel(const T* __restrict__ pos, const T* __restrict__ vocab,
                  const int32_t* __restrict__ chunk_tile,
                  int32_t* __restrict__ out, int64_t n_tiles, int tile_p,
                  int64_t events_per_cta, int chunks_per_cta) {
  extern __shared__ int32_t hist[];  // [kVocab][tile_p]
  const int bins = kVocab * tile_p;
  for (int i = threadIdx.x; i < bins; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * events_per_cta;
  for (int64_t k = threadIdx.x; k < events_per_cta; k += kThreads) {
    const int p = (int)pos[base + k];
    const int v = (int)vocab[base + k];
    if (p >= 0 && p < tile_p && v >= 0 && v < kVocab)
      atomicAdd(&hist[v * tile_p + p], 1);
  }
  __syncthreads();

  const int64_t tile = chunk_tile[(int64_t)blockIdx.x * chunks_per_cta];
  if (tile < 0 || tile >= n_tiles) return;
  const int64_t width = n_tiles * tile_p;
  for (int i = threadIdx.x; i < bins; i += kThreads) {
    const int32_t c = hist[i];
    if (c != 0)
      atomicAdd(&out[(int64_t)(i / tile_p) * width + tile * tile_p +
                     (i % tile_p)],
                c);
  }
}

template <typename T>
int launch(const void* pos, const void* vocab, const void* chunk_tile,
           int64_t n_chunks, void* out, int64_t n_tiles, int tile_p,
           int e_sub, int chunks_per_cta, void* stream) {
  if (n_chunks < 0 || n_tiles <= 0 || tile_p <= 0 || tile_p % kLane != 0 ||
      tile_p > kMaxTileP || e_sub <= 0 || chunks_per_cta <= 0 ||
      n_chunks % chunks_per_cta != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t grid = n_chunks / chunks_per_cta;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(int32_t) * kVocab * (size_t)tile_p;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_vote_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  chunk_vote_kernel<T><<<(unsigned)grid, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)vocab, (const int32_t*)chunk_tile,
      (int32_t*)out, n_tiles, tile_p,
      (int64_t)chunks_per_cta * e_sub * kLane, chunks_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

// pos, vocab: (n_chunks * e_sub * 128,) of int32 or uint8; chunk_tile:
// int32 (n_chunks,); out: int32 (8, n_tiles * tile_p), zero-filled;
// tile_p a multiple of 128 up to 2048; n_chunks a multiple of
// chunks_per_cta.  Launch on `stream`; return cudaGetLastError().
extern "C" int chunk_vote_i32(const void* pos, const void* vocab,
                              const void* chunk_tile, int64_t n_chunks,
                              void* out, int64_t n_tiles, int tile_p,
                              int e_sub, int chunks_per_cta, void* stream) {
  return launch<int32_t>(pos, vocab, chunk_tile, n_chunks, out, n_tiles,
                         tile_p, e_sub, chunks_per_cta, stream);
}

extern "C" int chunk_vote_u8(const void* pos, const void* vocab,
                             const void* chunk_tile, int64_t n_chunks,
                             void* out, int64_t n_tiles, int tile_p,
                             int e_sub, int chunks_per_cta, void* stream) {
  return launch<uint8_t>(pos, vocab, chunk_tile, n_chunks, out, n_tiles,
                         tile_p, e_sub, chunks_per_cta, stream);
}
