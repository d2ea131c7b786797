// The second pass of the transformer train kernels' per-slot gradients (KL,
// KU, KE backward and KN's train mode): each block of the first pass writes
// the partial sums of its tile of one slot's rows, partials f32[T, tiles,
// P], and tile_sum adds the tiles of each slot in a fixed order into
// out f32[T, P]. No float atomics: two runs give the same bits (the
// recurrent train kernels' tile_reduce, bptt.cuh, is the same pattern).
#pragma once
#include "common.cuh"

// out[t][p] = sum over tiles k, in order, of part[t][k][p]; with to_bf16
// the sum is rounded to bf16 (a gradient the reference computes as a bf16
// dot or reduction and widens to f32). Grid (ceil(P / 128), T), 128
// threads.
static __global__ void __launch_bounds__(128)
tile_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int tiles, int P,
                int to_bf16) {
  const int t = blockIdx.y;
  const int p = blockIdx.x * 128 + threadIdx.x;
  if (p >= P) return;
  const float* src = part + static_cast<long long>(t) * tiles * P + p;
  float s = 0.0f;
  for (int k = 0; k < tiles; ++k) s = __fadd_rn(s, src[static_cast<long long>(k) * P]);
  out[static_cast<long long>(t) * P + p] = to_bf16 ? round_bf16(s) : s;
}

inline int launch_tile_sum(const float* part, float* out, int T, int tiles, int P, int to_bf16,
                           cudaStream_t st) {
  tile_sum_kernel<<<dim3((P + 127) / 128, T), 128, 0, st>>>(part, out, tiles, P, to_bf16);
  return static_cast<int>(cudaGetLastError());
}

// Add a block's per-warp column sums into one row of partials in warp
// order (warp 0 first), through shared memory buf[n]: n columns, lane l of
// each warp holding columns l, l + 32, ... (vals[c] is column l + 32 c).
// Every thread of the block calls it; it ends with a barrier.
template <int VPT, int WARPS>
__device__ __forceinline__ void block_column_sums(const float (&vals)[VPT], float* buf,
                                                  float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < VPT; ++c) {
        const int i = lane + 32 * c;
        buf[i] = w == 0 ? vals[c] : __fadd_rn(buf[i], vals[c]);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 32 * VPT; i += 32 * WARPS) dst[i] = buf[i];
  __syncthreads();
}
