// KG gather_rows: counts-derived compaction of one flush's scored rows.
//
// Replaces sitewhere_tpu/parallel/sharded.py:415 _gather_fn: the score
// plane [L, B] (L = slots x data shards lanes, wire dtype) holds each
// lane's valid rows front-contiguous, counts[l] of them (clamped to
// [0, B]); out[size] receives them in (lane, row) order, and every entry
// past the total is NaN. Rows past `size` are dropped, as XLA's scatter
// mode="drop" drops them.
//
// Bound on the H100: it moves rows x 2-4 bytes in and size x 2-4 bytes
// out (tens of KB per flush), so launch latency sets the pace. Design: a
// gather, not a scatter: each block scans the L lane counts into shared
// memory (an exclusive scan, L is the slot count), then each thread owns
// output entries, finds its lane by binary search over the offsets and
// copies the row's bits, or writes NaN. Every entry is written exactly
// once, with no atomics, so the result is bitwise deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename E>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const E* __restrict__ scores, const int* __restrict__ counts, int L, int B,
                   E* __restrict__ out, long long size, E nan_bits) {
  extern __shared__ long long off[];  // [L + 1] exclusive offsets
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int l = 0; l < L; ++l) {
      off[l] = acc;
      const int c = counts[l];
      acc += c < 0 ? 0 : (c > B ? B : c);
    }
    off[L] = acc;
  }
  __syncthreads();
  const long long total = off[L];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < size;
       i += stride) {
    if (i >= total) {
      out[i] = nan_bits;
      continue;
    }
    int lo = 0, hi = L;  // last lane with off[lane] <= i
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= i) lo = mid; else hi = mid;
    }
    out[i] = scores[static_cast<long long>(lo) * B + (i - off[lo])];
  }
}

template <typename E>
int launch_kg(const void* scores, const int* counts, int L, int B, void* out, long long size,
              E nan_bits, cudaStream_t st) {
  const size_t smem = sizeof(long long) * (static_cast<size_t>(L) + 1);
  cudaError_t err = cudaFuncSetAttribute(gather_rows_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (size + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  gather_rows_kernel<E><<<static_cast<int>(blocks), kThreads, smem, st>>>(
      static_cast<const E*>(scores), counts, L, B, static_cast<E*>(out), size, nan_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sw_gather_rows(const void* scores, int kind, const int* counts, int L, int B,
                              void* out, long long size, void* stream) {
  if (size == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // quiet NaN bit patterns of each wire dtype (what jnp.full(nan) holds)
  if (kind == KIND_F32) return launch_kg<uint32_t>(scores, counts, L, B, out, size, 0x7FC00000u, st);
  if (kind == KIND_BF16) return launch_kg<uint16_t>(scores, counts, L, B, out, size, 0x7FC0, st);
  if (kind == KIND_F16) return launch_kg<uint16_t>(scores, counts, L, B, out, size, 0x7E00, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
