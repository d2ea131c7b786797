// KE, raw form for long histories: the transformer forecast's first step
// (normalize a raw history over all of its L values, keep the last
// `context` of them, embed them as tokens) at any L.
//
// Replaces, with tf_embed.cu's mode 2 (which holds a whole row in shared
// memory and so takes L up to 4,096), sitewhere_tpu/models/transformer.py
// :205-211 (normalize_windows over the raw history, common.py:142-153:
// mean, population std (ddof 0) plus eps 1e-6 outside the square root;
// the last C values, left-padded with the first when L < C) and the
// embedding of _backbone :74-75: x = ((v * w_e) + b_e) + pos[t], each op
// rounded in the compute dtype, as tf_embed.cu does.
//
// Outputs as tf_embed.cu's mode 2: the tokens x [1, B, C, D] in the compute
// dtype, the normalized context ctx_out f32[B, C], and each row's mu and
// sigma f32[B] (the forecast un-normalizes with them).
//
// Weight formats: the embed weight w_e read through wload (common.cuh) as
// stored (f32 masters, bf16, or int8 qw with f32 scales); b_e and pos f32.
//
// Bound on the H100: bytes. A row's history is read twice (the mean, then
// the squared deviations around it: the second read mostly from L2) and
// only C values of it are read a third time; the tokens are C x D values a
// row. Design: one block of 1,024 threads a row; each thread sums the
// values at its stride (tid, tid + 1024, ...) in index order, eight loads
// in flight before their adds, then a block-wide reduction (warp shuffles,
// then one warp over the warps' sums): the summation order is fixed, so two
// runs give the same bits. As tf_embed.cu's normalize_row the mean is
// summed relative to the row's first value (mu = x0 + sum(x - x0) / L),
// then sigma = sqrt(sum((x - mu)^2) / L) + 1e-6. The context and the
// tokens follow with consecutive threads on consecutive columns.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;

// block-wide sum of one value a thread (warp trees, then warp 0 over the
// warps' sums); every thread gets the result
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < kWarps ? red[lane] : 0.0f;
    u = warp_sum(u);
    if (lane == 0) red[kWarps] = u;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

// sum over this thread's values of row[0..L) at stride kThreads of
// (x - shift) (square = false) or (x - shift)^2 (square = true), in index
// order
__device__ float strided_sum(const float* __restrict__ row, long long L, float shift,
                             bool square) {
  float s = 0.0f;
  long long e = threadIdx.x;
  const long long step = static_cast<long long>(kThreads) * kUnroll;
  for (; e + static_cast<long long>(kThreads) * (kUnroll - 1) < L; e += step) {
    float v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = __ldg(row + e + static_cast<long long>(k) * kThreads);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const float d = __fsub_rn(v[k], shift);
      s = square ? fmaf(d, d, s) : __fadd_rn(s, d);
    }
  }
  for (; e < L; e += kThreads) {
    const float d = __fsub_rn(__ldg(row + e), shift);
    s = square ? fmaf(d, d, s) : __fadd_rn(s, d);
  }
  return s;
}

struct RawArgs {
  const void* ew; const float* es; const float* eb; const float* ptab;
  const float* src; long long L;
  void* x; float* ctx_out; float* mu_out; float* sigma_out;
  int D; int C;
};

template <bool BF16, int WF>
__global__ void __launch_bounds__(kThreads) tf_embed_raw_kernel(const RawArgs a) {
  extern __shared__ float ctx[];  // [C] the row's normalized context
  __shared__ float red[kWarps + 1];
  const long long b = blockIdx.x;
  const long long L = a.L;
  const int C = a.C, D = a.D;
  const float* row = a.src + b * L;
  const float x0 = __ldg(row);
  const float n = static_cast<float>(L);
  const float mu = __fadd_rn(x0, __fdiv_rn(block_sum(strided_sum(row, L, x0, false), red), n));
  const float sigma =
      __fadd_rn(sqrtf(__fdiv_rn(block_sum(strided_sum(row, L, mu, true), red), n)), 1e-6f);
  if (threadIdx.x == 0) {
    a.mu_out[b] = mu;
    a.sigma_out[b] = sigma;
  }
  // the last C values, left-padded with the first (index 0) when L < C
  const long long shift = L - C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const long long i = c + shift < 0 ? 0 : c + shift;
    const float v = __fdiv_rn(__fsub_rn(__ldg(row + i), mu), sigma);
    ctx[c] = v;
    a.ctx_out[b * C + c] = v;
  }
  __syncthreads();
  const int per_row = C * D;
  const long long out0 = b * per_row;
  for (int e = threadIdx.x; e < per_row; e += kThreads) {
    const int c = e / D, d = e - c * D;
    const float v = rb<BF16>(ctx[c]);
    float y = rb<BF16>(__fmul_rn(v, wload<WF, BF16>(a.ew, a.es, d, d)));
    y = rb<BF16>(__fadd_rn(y, rb<BF16>(a.eb[d])));
    y = __fadd_rn(y, rb<BF16>(a.ptab[e]));
    store_val(a.x, BF16 ? KIND_BF16 : KIND_F32, out0 + e, y);
  }
}

template <bool BF16, int WF>
int launch_raw(const RawArgs& a, int B, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(tf_embed_raw_kernel<BF16, WF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tf_embed_raw_kernel<BF16, WF><<<B, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ew: the embed weight [1, 1, D] as stored in format wf (WF_F32, WF_BF16,
// WF_I8; es its int8 scales [1, 1, D], else null); eb f32[1, D]; ptab f32[1,
// P, D] with P >= C; src f32[B, L], any L >= 1; x [1, B, C, D] in the
// compute dtype (kind); ctx_out f32[B, C]; mu_out, sigma_out f32[B].
extern "C" int sw_tf_embed_raw(const void* ew, const float* es, int wf, const float* eb,
                               const float* ptab, int P, const float* src, long long L, void* x,
                               float* ctx_out, float* mu_out, float* sigma_out, int B, int D,
                               int C, int kind, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (B < 0 || L < 1 || D < 1 || C < 1 || C > P || (kind != KIND_F32 && kind != KIND_BF16) ||
      (wf == WF_I8) != (es != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  RawArgs a{ew, es, eb, ptab, src, L, x, ctx_out, mu_out, sigma_out, D, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_format(wf, [&](auto f) {
    return by_bf16(kind == KIND_BF16, [&](auto bb) {
      return launch_raw<decltype(bb)::value, decltype(f)::value>(a, B, smem, st);
    });
  });
}
