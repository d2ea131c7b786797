// KL layernorm: per-row LayerNorm with per-slot f32 scale and bias.
//
// Replaces sitewhere_tpu/models/common.py:295 layernorm_stacked as the
// transformer family's blocks call it for ln1 and ln2 (:329), over rows
// x [N, D] in the compute dtype where row n belongs to slot n /
// rows_per_slot. Math as the reference: the row widened to f32, mean =
// sum / D and var = sum((x - mean)^2) / D (XLA multiplies by 1/D), y =
// (x - mean) * rsqrt(var + 1e-5), out = y * scale + bias in f32 (two
// rounded ops, not an FMA), cast back to the input dtype.
//
// Bound on the H100: bytes. Each row is read once and written once (2 * D
// values) for ~8 D operations. Design: one warp per row, the row held in
// registers (D / 32 values a lane, loads coalesced across the warp), the
// two sums reduced by shuffles; eight rows a block.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <bool BF16, int VPT>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_kernel(const void* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out, long long N,
                 long long rows_per_slot) {
  constexpr int D = 32 * VPT;
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const int lane = threadIdx.x & 31;
  const long long off = row * D;
  float v[VPT];
#pragma unroll
  for (int c = 0; c < VPT; ++c) v[c] = load_val(x, kind, off + lane + 32 * c);
  const float r = warp_ln_center<VPT>(v);
  const long long p = (row / rows_per_slot) * D;
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    const int d = lane + 32 * c;
    store_val(out, kind, off + d, ln_affine(v[c], r, scale[p + d], bias[p + d]));
  }
}

template <bool BF16>
int launch_kl(const void* x, const float* scale, const float* bias, void* out, long long N,
              int D, long long rows_per_slot, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((N + kRowsPerBlock - 1) / kRowsPerBlock);
  const int threads = kRowsPerBlock * 32;
#define SW_KL_CASE(V)                                                                   \
  case 32 * V:                                                                          \
    layernorm_kernel<BF16, V><<<grid, threads, 0, st>>>(x, scale, bias, out, N, rows_per_slot); \
    break;
  switch (D) {
    SW_KL_CASE(1)
    SW_KL_CASE(2)
    SW_KL_CASE(4)
    SW_KL_CASE(8)
    SW_KL_CASE(16)
    SW_KL_CASE(24)
    SW_KL_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SW_KL_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [N, D] (kind KIND_F32 or KIND_BF16); scale, bias: f32[N /
// rows_per_slot, D]; D one of 32, 64, 128, 256, 512, 768, 1024.
extern "C" int sw_layernorm(const void* x, const float* scale, const float* bias, void* out,
                            long long N, int D, long long rows_per_slot, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (rows_per_slot < 1 || (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? launch_kl<true>(x, scale, bias, out, N, D, rows_per_slot, st)
                           : launch_kl<false>(x, scale, bias, out, N, D, rows_per_slot, st);
}
