// KH score_sketch: per-slot fixed-bin histogram of one flush's scores.
//
// Replaces sitewhere_tpu/parallel/sharded.py:511 sketch_of, the score
// sketch the fused step emits: for slot t, bin = searchsorted(edges, s,
// side="right") (the count of edges <= s, np.histogram's left-closed
// bins) over the wire-cast scores of the valid rows of active slots; NaN
// scores are dropped. Output i32[T, 1, nbins] (the data-shard axis is 1).
//
// Bound on the H100: a flush reads T*B wire scores (256 KB at tenants32,
// f32) and writes T*64 counts, so launch latency sets the pace. Design:
// blocks of 1024 rows of one slot; each thread bins its rows by binary
// search over the edges in shared memory and adds to a shared-memory
// histogram; the block then adds its non-zero bins into the output with
// integer atomics. Integer sums do not depend on order, so the result is
// deterministic. The output is zeroed on the same stream first.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kMaxBins = 256;

__global__ void __launch_bounds__(kThreads)
score_sketch_kernel(const void* __restrict__ scores, int kind,
                    const unsigned char* __restrict__ active, const int* __restrict__ counts,
                    const unsigned char* __restrict__ mask, const float* __restrict__ edges,
                    int n_edges, int* __restrict__ out, int B) {
  __shared__ int hist[kMaxBins];
  __shared__ float e[kMaxBins];
  const int nbins = n_edges + 1;
  const int t = blockIdx.y;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x) e[i] = edges[i];
  __syncthreads();
  if (active[t]) {
    const int begin = static_cast<int>(blockIdx.x) * kTile;
    const int end = min(B, begin + kTile);
    for (int b = begin + static_cast<int>(threadIdx.x); b < end; b += blockDim.x) {
      if (!row_valid(counts, mask, t, b, B)) continue;
      const float s = load_val(scores, kind, static_cast<long long>(t) * B + b);
      if (isnan(s)) continue;
      int lo = 0, hi = n_edges;  // first edge > s
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (e[mid] <= s) lo = mid + 1; else hi = mid;
      }
      atomicAdd(&hist[lo], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    if (hist[i] != 0) atomicAdd(&out[t * nbins + i], hist[i]);
  }
}

}  // namespace

extern "C" int sw_score_sketch(const void* scores, int kind, const unsigned char* active,
                               const int* counts, const unsigned char* mask, const float* edges,
                               int n_edges, int* out, int T, int B, void* stream) {
  if (n_edges + 1 > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * T * (n_edges + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((B + kTile - 1) / kTile, T);
  score_sketch_kernel<<<grid, kThreads, 0, st>>>(scores, kind, active, counts, mask, edges,
                                                 n_edges, out, B);
  return static_cast<int>(cudaGetLastError());
}
