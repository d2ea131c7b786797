// KW window_update: append one flush into the per-stream ring buffers.
//
// Replaces sitewhere_tpu/ops/windows.py _segment_ranks (:66) +
// _apply_update (:94), as update_gather_ranked (:183) runs them inside the
// fused step (parallel/sharded.py:564). Per slot t of the stacked state
// ring f32[T, S, W], pos/count i32[T, S]:
//   - rank of each valid row among the valid rows of its stream (stable:
//     row order), and the stream's row total in this flush;
//   - ring[t, id, (pos + rank) % W] = value, for the newest W rows of each
//     stream only (pos read before the update);
//   - pos = (pos + total) % W, count += total, by one writer per stream;
//   - later[t, b] = total - 1 - rank for valid rows, else 0.
// Ids outside [0, S) are read nowhere and write nothing (XLA's scatter
// mode="drop"); negative ids are outside the contract (ids are u16 or
// registry-assigned, never negative).
//
// Bound on the H100: a flush moves well under 1 MB (ids, values, the touched
// pos/count words, the written ring words, later), so launch latency and the
// in-block sort set the pace, not HBM. Design: one block per slot, no atomics
// anywhere, so the result is deterministic. The block sorts (key, row) pairs
// in dynamic shared memory with a bitonic network (key = stream id + 1, 0 for
// invalid rows, row index in the low 15 bits, so equal keys keep row order),
// finds each row's run by binary search over the sorted keys, and lets the
// run's last row alone advance pos/count after a barrier, so every ring write
// saw the pre-update pos.
#include "common.cuh"

namespace {

constexpr int kRowBits = 15;  // rows per slot < 2^15 (the wrapper checks B <= 16384)
constexpr int kThreads = 1024;

__device__ __forceinline__ int lower_bound_keys(const unsigned long long* keys, int n,
                                                unsigned long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
window_update_kernel(float* __restrict__ ring, int* __restrict__ pos, int* __restrict__ count,
                     int S, int W, const void* __restrict__ ids, int id_kind,
                     const void* __restrict__ vals, int val_kind, const int* __restrict__ counts,
                     const unsigned char* __restrict__ mask, int* __restrict__ later, int B,
                     int NP) {
  extern __shared__ unsigned long long keys[];
  const int t = blockIdx.x;
  const long long row0 = static_cast<long long>(t) * B;

  for (int i = threadIdx.x; i < NP; i += blockDim.x) {
    unsigned long long k = ~0ull;  // padding sorts last
    if (i < B) {
      unsigned long long g = 0;  // invalid rows: one run of key 0
      if (row_valid(counts, mask, t, i, B)) {
        g = static_cast<unsigned long long>(
                static_cast<uint32_t>(load_id(ids, id_kind, row0 + i))) + 1ull;
      }
      k = (g << kRowBits) | static_cast<unsigned long long>(i);
    }
    keys[i] = k;
  }
  __syncthreads();

  // bitonic sort, ascending; NP is a power of two
  for (int size = 2; size <= NP; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (NP >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // ranks, later, and the ring writes (pos is read, not yet written)
  const long long slot_base = static_cast<long long>(t) * S;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const unsigned long long k = keys[i];
    const unsigned long long g = k >> kRowBits;
    const int row = static_cast<int>(k & ((1ull << kRowBits) - 1));
    if (g == 0) {
      later[row0 + row] = 0;
      continue;
    }
    const int first = lower_bound_keys(keys, B, g << kRowBits);
    const int end = lower_bound_keys(keys, B, (g + 1) << kRowBits);
    const int rank = i - first, total = end - first;
    later[row0 + row] = total - 1 - rank;
    const long long id = load_id(ids, id_kind, row0 + row);
    if (id < 0 || id >= S) continue;      // dropped write
    if (rank < total - W) continue;       // only the newest W rows write
    const long long s = slot_base + id;
    const int w = (pos[s] + rank) % W;
    ring[s * W + w] = load_val(vals, val_kind, row0 + row);
  }
  __syncthreads();

  // one writer per stream: the run's last row advances pos and count
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const unsigned long long g = keys[i] >> kRowBits;
    if (g == 0) continue;
    if (i + 1 < B && (keys[i + 1] >> kRowBits) == g) continue;
    const int row = static_cast<int>(keys[i] & ((1ull << kRowBits) - 1));
    const long long id = load_id(ids, id_kind, row0 + row);
    if (id < 0 || id >= S) continue;
    const int total = i + 1 - lower_bound_keys(keys, B, g << kRowBits);
    const long long s = slot_base + id;
    pos[s] = (pos[s] + total) % W;
    count[s] += total;
  }
}

}  // namespace

extern "C" int sw_window_update(float* ring, int* pos, int* count, int S, int W,
                                const void* ids, int id_kind, const void* vals, int val_kind,
                                const int* counts, const unsigned char* mask, int* later,
                                int T, int B, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  int np2 = 2;
  while (np2 < B) np2 <<= 1;
  const size_t smem = static_cast<size_t>(np2) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      window_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = np2 / 2 < kThreads ? (np2 / 2 < 32 ? 32 : np2 / 2) : kThreads;
  window_update_kernel<<<T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ring, pos, count, S, W, ids, id_kind, vals, val_kind, counts, mask, later, B, np2);
  return static_cast<int>(cudaGetLastError());
}
