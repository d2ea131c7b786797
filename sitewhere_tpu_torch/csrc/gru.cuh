// The DeepAR GRU's arithmetic, shared by KD (gru_score.cu) and KF
// (deepar_forecast.cu): one gate column's input and recurrent terms and
// the cell update, with the reference's bf16 rounding points
// (sitewhere_tpu/models/deepar.py:58-81, :111-119). The
// explicit _rn intrinsics keep nvcc from contracting a product and a sum
// into one FMA where the reference rounds between them.
#pragma once
#include "common.cuh"

// gx = x_t * wx[j] + bx[j]: the product, then the bias add, each rounded.
template <bool BF16>
__device__ __forceinline__ float gru_gx(float x, float wxj, float bxj) {
  return rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(rb<BF16>(x), wxj)), bxj));
}

// gh = h . wh[:, j] + bh[j]: the f32-accumulated dot rounded once, then
// the bias add rounded.
template <bool BF16>
__device__ __forceinline__ float gru_gh(float acc, float bhj) {
  return rb<BF16>(__fadd_rn(rb<BF16>(acc), bhj));
}

// h' = (1 - z) * n + z * h with r = sigmoid(rx + rh), z = sigmoid(zx + zh),
// n = tanh(nx + r * nh); sr and sz are the rounded gate sums.
template <bool BF16>
__device__ __forceinline__ float gru_cell(float sr, float sz, float nx, float nh, float h) {
  const float r = sigm<BF16>(sr);
  const float z = sigm<BF16>(sz);
  const float n = rb<BF16>(tanhf(rb<BF16>(__fadd_rn(nx, rb<BF16>(__fmul_rn(r, nh))))));
  return rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(rb<BF16>(__fsub_rn(1.0f, z)), n)),
                            rb<BF16>(__fmul_rn(z, h))));
}
