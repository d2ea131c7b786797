// KW window_update, multi-block form: append one flush of any length into
// the per-stream ring buffers.
//
// Replaces sitewhere_tpu/ops/windows.py _segment_ranks (:66) +
// _apply_update (:94), as update_windows (:131) and update_gather_ranked
// (:183) run them, for the slots whose flush is longer than the one-block
// KW (window_update.cu) sorts in one block's shared memory: config 1's
// 65,536-row bucket on one slot (bench.py:797, :2038), and any row count
// an int32 row index takes. The contract is the one-block form's, bit for
// bit: per slot t of ring f32[T, S, W], pos/count i32[T, S],
//   - rank of each valid row among the valid rows of its stream (stable:
//     row order), and the stream's row total in this flush;
//   - ring[t, id, (pos + rank) % W] = value, for the newest W rows of each
//     stream only (pos read before the update);
//   - pos = (pos + total) % W, count += total, by one writer per stream;
//   - later[t, b] = total - 1 - rank for valid rows, else 0.
// Ids outside [0, S) are ranked and write nothing.
//
// Design: a stable sort of each slot's keys (key = (stream id + 1) << 31 |
// row, 0 in the high part for invalid rows; keys are unique, so equal
// streams keep row order), in four launches of a C entry, no atomics, so
// the result is deterministic:
//   (a) kw_chunk_sort: one block per chunk of C rows (C a power of two)
//       sorts its keys in shared memory with a bitonic network;
//   (b) kw_merge, log2(B / C) times: every key finds its place in the
//       merge of two adjacent sorted runs by a binary search in the other
//       run (merge path), one thread a key, ping-ponging two scratch
//       buffers;
//   (c) kw_rank_write: one thread per sorted position finds its run by
//       binary search (rank, total), writes later and the ring word;
//   (d) kw_advance: the last key of each run advances pos and count, after
//       (c) has read every pos.
// Bound on the H100: bytes and latency. A 65,536-row flush moves ~1.5 MB
// (ids, values, later, the touched ring/pos/count words; the keys' scratch
// stays in L2), ~0.5 us at 3.35 TB/s; the sort's dependent passes and the
// launches set the pace.
#include "common.cuh"

namespace {

constexpr int kRowShift = 31;  // key = (stream id + 1) << 31 | row; rows < 2^31
constexpr unsigned long long kRowMask = (1ull << kRowShift) - 1ull;
constexpr int kThreads = 256;  // threads of the per-key passes
constexpr int kSortThreads = 1024;

typedef unsigned long long u64;

__device__ __forceinline__ u64 row_key(const void* ids, int id_kind, const int* counts,
                                       const unsigned char* mask, int t, long long i, int B) {
  u64 g = 0;  // invalid rows: stream 0, before every real stream
  if (row_valid(counts, mask, t, static_cast<int>(i), B)) {
    g = static_cast<u64>(static_cast<uint32_t>(
            load_id(ids, id_kind, static_cast<long long>(t) * B + i))) + 1ull;
  }
  return (g << kRowShift) | static_cast<u64>(i);
}

// the first index of sorted a[0, n) whose key is not below x
__device__ __forceinline__ long long lower_bound_u64(const u64* a, long long n, u64 x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kSortThreads)
kw_chunk_sort(const void* __restrict__ ids, int id_kind, const int* __restrict__ counts,
              const unsigned char* __restrict__ mask, u64* __restrict__ out, int B, int C) {
  extern __shared__ u64 keys[];
  const int t = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * C;
  const int n = static_cast<int>(min(static_cast<long long>(C), B - c0));
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    keys[i] = i < n ? row_key(ids, id_kind, counts, mask, t, c0 + i, B) : ~0ull;
  }
  __syncthreads();
  for (int size = 2; size <= C; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (C >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = keys[lo], b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  u64* dst = out + static_cast<long long>(t) * B + c0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = keys[i];
}

__global__ void __launch_bounds__(kThreads)
kw_merge(const u64* __restrict__ src, u64* __restrict__ dst, int B, long long w) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const long long base = static_cast<long long>(blockIdx.y) * B;
  const long long a0 = j / (2 * w) * (2 * w);
  const long long mid = min(a0 + w, static_cast<long long>(B));
  const long long end = min(a0 + 2 * w, static_cast<long long>(B));
  const u64 key = src[base + j];
  const long long at = j < mid ? (j - a0) + lower_bound_u64(src + base + mid, end - mid, key)
                               : (j - mid) + lower_bound_u64(src + base + a0, mid - a0, key);
  dst[base + a0 + at] = key;
}

__global__ void __launch_bounds__(kThreads)
kw_rank_write(const u64* __restrict__ keys, float* __restrict__ ring, const int* __restrict__ pos,
              int S, int W, const void* __restrict__ ids, int id_kind,
              const void* __restrict__ vals, int val_kind, int* __restrict__ later, int B) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int t = blockIdx.y;
  const long long base = static_cast<long long>(t) * B;
  const u64* k = keys + base;
  const u64 g = k[i] >> kRowShift;
  const long long row = static_cast<long long>(k[i] & kRowMask);
  if (g == 0) {
    later[base + row] = 0;
    return;
  }
  const long long first = lower_bound_u64(k, B, g << kRowShift);
  const long long end = lower_bound_u64(k, B, (g + 1) << kRowShift);
  const long long rank = i - first, total = end - first;
  later[base + row] = static_cast<int>(total - 1 - rank);
  const long long id = load_id(ids, id_kind, base + row);
  if (id < 0 || id >= S) return;  // dropped write
  if (rank < total - W) return;   // only the newest W rows write
  const long long s = static_cast<long long>(t) * S + id;
  const long long w = (pos[s] + rank) % W;
  ring[s * W + w] = load_val(vals, val_kind, base + row);
}

__global__ void __launch_bounds__(kThreads)
kw_advance(const u64* __restrict__ keys, int* __restrict__ pos, int* __restrict__ count, int S,
           int W, const void* __restrict__ ids, int id_kind, int B) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int t = blockIdx.y;
  const long long base = static_cast<long long>(t) * B;
  const u64* k = keys + base;
  const u64 g = k[i] >> kRowShift;
  if (g == 0) return;
  if (i + 1 < B && (k[i + 1] >> kRowShift) == g) return;  // not the run's last
  const long long row = static_cast<long long>(k[i] & kRowMask);
  const long long id = load_id(ids, id_kind, base + row);
  if (id < 0 || id >= S) return;
  const long long total = i + 1 - lower_bound_u64(k, B, g << kRowShift);
  const long long s = static_cast<long long>(t) * S + id;
  pos[s] = static_cast<int>((pos[s] + total) % W);
  count[s] += static_cast<int>(total);
}

}  // namespace

// chunk: rows a block sorts in shared memory (a power of two, 8 bytes a
// key); keys_a, keys_b: scratch of T * B keys each.
extern "C" int sw_window_update_multi(float* ring, int* pos, int* count, int S, int W,
                                      const void* ids, int id_kind, const void* vals,
                                      int val_kind, const int* counts, const unsigned char* mask,
                                      int* later, int T, int B, int chunk, u64* keys_a,
                                      u64* keys_b, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (chunk < 2 || (chunk & (chunk - 1)) != 0 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(chunk) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(kw_chunk_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sort_threads = chunk / 2 < kSortThreads ? (chunk / 2 < 32 ? 32 : chunk / 2)
                                                    : kSortThreads;
  const dim3 chunks((B + chunk - 1) / chunk, T);
  kw_chunk_sort<<<chunks, sort_threads, smem, st>>>(ids, id_kind, counts, mask, keys_a, B, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 per_key((B + kThreads - 1) / kThreads, T);
  u64* src = keys_a;
  u64* dst = keys_b;
  for (long long w = chunk; w < B; w *= 2) {
    kw_merge<<<per_key, kThreads, 0, st>>>(src, dst, B, w);
    u64* tmp = src;
    src = dst;
    dst = tmp;
  }
  kw_rank_write<<<per_key, kThreads, 0, st>>>(src, ring, pos, S, W, ids, id_kind, vals, val_kind,
                                              later, B);
  kw_advance<<<per_key, kThreads, 0, st>>>(src, pos, count, S, W, ids, id_kind, B);
  return static_cast<int>(cudaGetLastError());
}
