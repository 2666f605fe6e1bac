// Overflow vote kernel: the cap-overflow list of a lane pack added into
// kernel A's counts, in place.
//
// Replaces, on the lanes path, what the JAX LanesPolisher runs over the
// overflow list (polypolish_tpu/models/polisher.py, vote_counts): TPU
// kernel B, _make_vote_kernel_split of polypolish_tpu/ops/vote_pallas.py
// (_vote_pallas_call, :394), over the list laid out as chunks (its "mxu"
// overflow mode), or the XLA scatter-add _ov_add (its "scatter" mode).
// Both compute counts[vid, pos] += 1 for each event, and only that
// function carries over.  The chunk layout existed to feed the TPU's
// matrix unit, where a scatter cost some 8 ns an event; on the H100 an
// integer atomic does not, and the layout cost the host a pass over
// every tile of the contig on every call.
//
// Contract.  pos int32 and vid uint8, n events each, as
// pp_lanes_from_runs leaves them: sorted by (pos, vid).  counts int32
// (8, width), row major, kernel A's output.  Each event adds one to
// counts[vid, pos] with the semantics of JAX's mode="drop" scatter: a
// pos in [-width, 0) wraps to pos + width, any other pos outside
// [0, width) drops, and so does a vid >= 8.  The adds go into counts in
// place: no zero-fill and no second tensor.  A list out of order is
// counted right too; it only merges less.
//
// What bounds it on an H100: bytes.  Each event is read once (5 bytes)
// and each distinct (pos, vid) word of counts read and written once by
// its atomic.  At E. coli (218 K events, about 1 MB) that is well under
// a microsecond of memory time, so one launch's overhead is the floor.
//
// Design.  A thread takes 16 consecutive events (one 16-byte load of
// vid, four of pos), a warp 512.  The list is sorted, so equal keys are
// neighbours: the thread walks the runs of equal (pos, vid) among its 16
// events, and a segmented scan across the warp (__shfl_up_sync) joins a
// run that spans threads, so each run of a warp's 512 events costs one
// atomicAdd of its length, issued by the thread where the run ends.
// Integer atomics commute: the counts are bitwise exact in any order.
// Warps stride over the list in 512-event spans, so one grid of
// kMaxBlocks blocks takes any length.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 8;    // dense vocab rows of counts
constexpr int kPer = 16;     // events per thread: one 16-byte vid load
constexpr int kThreads = 256;
constexpr int kWarpEvents = 32 * kPer;
// one wave of 256-thread blocks on the H100's 132 SMs (8 blocks each);
// longer lists loop
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the key of a slot past the list: no event has it (real keys are 40 bits)
constexpr uint64_t kNone = ~0ull;

__device__ __forceinline__ uint64_t key_of(int32_t pos, uint32_t vid) {
  return ((uint64_t)(uint32_t)pos << 8) | vid;
}

// counts[vid, pos] += len for a run of one key, with the drop semantics.
__device__ __forceinline__ void add_run(int32_t* __restrict__ counts,
                                        int64_t width, uint64_t key,
                                        int len) {
  if (key == kNone) return;
  const uint32_t vid = (uint32_t)(key & 0xFF);
  int64_t pos = (int32_t)(uint32_t)(key >> 8);
  if (pos < 0) pos += width;
  if (vid < (uint32_t)kVocab && pos >= 0 && pos < width)
    atomicAdd(&counts[(int64_t)vid * width + pos], len);
}

// The keys of events [base, base + kPer); slots past n get kNone.
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ pos,
                                          const uint8_t* __restrict__ vid,
                                          int64_t base, int64_t n,
                                          uint64_t (&key)[kPer]) {
  if (base + kPer <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(vid + base));
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
    const int4* p4 = reinterpret_cast<const int4*>(pos + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 p = __ldg(p4 + q);
      const int32_t pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        key[4 * q + k] = key_of(pw[k], (vw[q] >> (8 * k)) & 0xFFu);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      key[k] = base + k < n ? key_of(__ldg(pos + base + k),
                                     __ldg(vid + base + k))
                            : kNone;
  }
}

__global__ void __launch_bounds__(kThreads)
overflow_vote_kernel(const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ vid, int64_t n,
                     int32_t* __restrict__ counts, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  // the loop bounds are the same for the whole warp, so every shuffle
  // below has all 32 lanes
  for (int64_t span = (int64_t)blockIdx.x * (kThreads / 32) +
                      threadIdx.x / 32;
       span * kWarpEvents < n; span += warps) {
    uint64_t key[kPer];
    load_keys(pos, vid, span * kWarpEvents + (int64_t)lane * kPer, n, key);

    // this thread's runs: the first (head) and last (tail) may go on in
    // the neighbouring threads; the ones between are added here
    int head_len = 0, len = 1;
    uint64_t cur = key[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k) {
      if (key[k] == cur) {
        ++len;
      } else {
        if (head_len == 0)
          head_len = len;
        else
          add_run(counts, width, cur, len);
        cur = key[k];
        len = 1;
      }
    }
    const bool single = head_len == 0;  // one run over all kPer events
    const uint64_t head_key = key[0], tail_key = cur;
    const uint64_t prev_tail = __shfl_up_sync(kFull, tail_key, 1);
    const bool cont = lane > 0 && prev_tail == head_key;

    // segmented inclusive scan of the tail runs' lengths: a segment
    // starts at each thread whose tail run does not go on from the left
    int total = len;
    bool start = !(single && cont);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, total, d);
      const int up_start = __shfl_up_sync(kFull, (int)start, d);
      if (lane >= d) {
        if (!start) total += up;
        start = start || up_start;
      }
    }
    // the run that ends at the previous thread's tail goes on into our
    // head: a head that is not also our tail adds it with its own
    const int prev_total = __shfl_up_sync(kFull, total, 1);
    if (!single)
      add_run(counts, width, head_key, head_len + (cont ? prev_total : 0));
    // a tail run that does not go on into the next thread ends here
    const bool next_cont = __shfl_down_sync(kFull, (int)cont, 1) != 0;
    if (lane == 31 || !next_cont) add_run(counts, width, tail_key, total);
  }
}

}  // namespace

// Events per pass of the grid: a list longer than this makes each warp
// loop (the CUDA tests use it to reach the loop).
extern "C" int64_t overflow_vote_grid_events() {
  return kMaxBlocks * kThreads * kPer;
}

// pos: int32 (n,), vid: uint8 (n,), both 16-byte aligned; counts: int32
// (8, width), row major.  Adds each event into counts as the contract
// above says, on `stream`, and returns cudaGetLastError().  n == 0
// launches nothing.
extern "C" int overflow_vote(const void* pos, const void* vid, int64_t n,
                             void* counts, int64_t width, void* stream) {
  if (n < 0 || width <= 0 ||
      ((uintptr_t)pos | (uintptr_t)vid) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t spans = (n + kWarpEvents - 1) / kWarpEvents;
  int64_t blocks = (spans + kThreads / 32 - 1) / (kThreads / 32);
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  overflow_vote_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const uint8_t*)vid, n, (int32_t*)counts, width);
  return (int)cudaGetLastError();
}
