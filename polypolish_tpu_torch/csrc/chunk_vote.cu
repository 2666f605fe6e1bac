// Chunk vote kernel: dense pileup counts from the chunk layout.
//
// Replaces the TPU kernel polypolish_tpu/ops/vote_pallas.py
// _make_vote_kernel_split (launched by _vote_pallas_call, fused="split"),
// a one-hot matmul on the TPU's matrix unit.  Only its contract carries
// over.
//
// Contract.  A chunk is 1,024 events (8 rows of 128) of one tile of 256
// positions: chunk_pos[e] is the tile-local position, chunk_vocab[e] the
// vocab id, chunk_tile[c] the tile.  out[v, tile*256 + pos] (int32, 8
// rows of n_tiles*256, zero-filled by the caller) += number of events
// with that (v, pos).  Events with pos outside [0, 256) or vocab outside
// [0, 8) count nothing, which covers both pad conventions: int32 with
// pos -1 (prepare_chunks) and uint8 with vocab 255 (pp_chunks_from_runs).
// Chunks whose tile lies outside [0, n_tiles) count nothing.
//
// What bounds it on an H100: bytes.  Each chunk is read once (2 or 8
// bytes per event) and the (8, n_tiles*256) output written once; the
// work per event is one shared-memory atomic.  On the main path it folds
// the cap-overflow list, whose chunk stream gives every tile at least
// one (mostly pad) chunk, so input and output bytes dominate.
//
// Design.  One CTA per chunk builds an 8x256 int32 histogram in shared
// memory (8 KB) with shared-memory atomics, then adds its non-zero bins
// to the output with global integer atomicAdd.  Integer atomics are
// exact and order-free, so the result is bitwise deterministic however
// the CTAs are scheduled; most bins of a sparse chunk are zero and cost
// no global traffic.  Tuning is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileP = 256;     // positions per tile
constexpr int kChunk = 1024;    // events per chunk (e_sub 8 x 128 lanes)
constexpr int kVocab = 8;       // dense vocab rows
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_vote_kernel(const T* __restrict__ pos, const T* __restrict__ vocab,
                  const int32_t* __restrict__ chunk_tile,
                  int32_t* __restrict__ out, int64_t n_tiles) {
  __shared__ int32_t hist[kVocab * kTileP];
  for (int i = threadIdx.x; i < kVocab * kTileP; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * kChunk;
#pragma unroll
  for (int k = 0; k < kChunk / kThreads; ++k) {
    const int64_t e = base + k * kThreads + threadIdx.x;
    const int p = (int)pos[e];
    const int v = (int)vocab[e];
    if (p >= 0 && p < kTileP && v >= 0 && v < kVocab)
      atomicAdd(&hist[v * kTileP + p], 1);
  }
  __syncthreads();

  const int64_t tile = chunk_tile[blockIdx.x];
  if (tile < 0 || tile >= n_tiles) return;
  const int64_t width = n_tiles * kTileP;
  for (int i = threadIdx.x; i < kVocab * kTileP; i += kThreads) {
    const int32_t c = hist[i];
    if (c != 0)
      atomicAdd(&out[(int64_t)(i / kTileP) * width + tile * kTileP +
                     (i % kTileP)],
                c);
  }
}

template <typename T>
int launch(const void* pos, const void* vocab, const void* chunk_tile,
           int64_t n_chunks, void* out, int64_t n_tiles, void* stream) {
  if (n_chunks < 0 || n_chunks > 0x7FFFFFFF || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  chunk_vote_kernel<T><<<(unsigned)n_chunks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)vocab, (const int32_t*)chunk_tile,
      (int32_t*)out, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// pos, vocab: (n_chunks * 1024,) of int32 or uint8; chunk_tile: int32
// (n_chunks,); out: int32 (8, n_tiles * 256), zero-filled.  Launch on
// `stream`; return cudaGetLastError().
extern "C" int chunk_vote_i32(const void* pos, const void* vocab,
                              const void* chunk_tile, int64_t n_chunks,
                              void* out, int64_t n_tiles, void* stream) {
  return launch<int32_t>(pos, vocab, chunk_tile, n_chunks, out, n_tiles,
                         stream);
}

extern "C" int chunk_vote_u8(const void* pos, const void* vocab,
                             const void* chunk_tile, int64_t n_chunks,
                             void* out, int64_t n_tiles, void* stream) {
  return launch<uint8_t>(pos, vocab, chunk_tile, n_chunks, out, n_tiles,
                         stream);
}
