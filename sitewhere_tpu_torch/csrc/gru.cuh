// The DeepAR GRU's arithmetic, shared by KD (gru_score.cu) and KF
// (deepar_forecast.cu): one gate column's input and recurrent terms, the
// cell update and the (mu, sigma) head epilogue, with the reference's bf16
// rounding points (sitewhere_tpu/models/deepar.py:58-81, :111-119). The
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

// sigma = softplus(raw) + 1e-4, softplus = logaddexp(raw, 0) as
// jax.nn.softplus computes it (no threshold).
__device__ __forceinline__ float deepar_sigma(float raw) {
  return __fadd_rn(__fadd_rn(fmaxf(raw, 0.0f), log1pf(expf(-fabsf(raw)))), 1e-4f);
}

// Gaussian NLL 0.5 log(2 pi sigma^2) + (t - mu)^2 / (2 sigma^2), in f32.
__device__ __forceinline__ float gaussian_nll(float t, float mu, float sigma) {
  const float s2 = __fmul_rn(sigma, sigma);
  const float d = __fsub_rn(t, mu);
  return __fadd_rn(__fmul_rn(0.5f, logf(__fmul_rn(6.2831855f, s2))),
                   __fdiv_rn(__fmul_rn(d, d), __fmul_rn(2.0f, s2)));
}
