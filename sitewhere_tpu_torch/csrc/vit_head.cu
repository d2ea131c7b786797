// KT vit_head: the ViT's final LayerNorm on the [CLS] row, the class head,
// the f32 softmax and the top-k, one pass per frame.
//
// Replaces what sitewhere_tpu runs after the ViT's last block:
// models/vit.py:92-93 (ln_f, then dense(head, x[:, 0]) cast to f32: apply's
// logits) and the classify dispatch's epilogue,
// services/streaming_media.py:154-155 and :201-202 (jax.nn.softmax, then
// jax.lax.top_k). ln_f runs on the [CLS] row only: LayerNorm is per row, so
// that is what the reference's ln_f over every row gives at row 0. Rounding
// as the reference: f32 statistics (mean = sum / D as XLA multiplies by
// 1/D, var likewise, rsqrt(var + 1e-5)), the affine in f32, the result
// rounded to the compute dtype; each logit an f32-accumulated dot of that
// row with the head column (weights rounded to the compute dtype), rounded,
// plus the rounded bias, rounded, widened to f32; softmax exp(l - max) /
// sum in f32; the top-k by probability, the lower class index first on
// ties (jax.lax.top_k's order; torch.topk's is not defined).
//
// Bound on the H100: bytes. At ViT-B/16's batch of 64 the head reads 3.1
// MB of f32 weights and writes 0.26 MB of logits (~1.0 us at 3.35 TB/s);
// its 98 MFLOP multiply operands rounded to bf16 with f32 accumulation,
// 0.1 us at the tensor cores' 989 TFLOP/s. This kernel does them as f32
// FMAs on the CUDA cores (1.5 us at 67 TFLOP/s), reading the head once
// from device memory, then from L2 by every frame's block. Design: one
// block per frame; the normalized [CLS]
// row lives in shared memory; each thread owns four adjacent classes (one
// 16-byte load a row of the head, coalesced across the warp; classes one
// by one when C is not a multiple of 4), summing over the row; the
// softmax's max and sum and the K rounds of the top-k (a block-wide
// argmax, ties to the lower index, the winner struck out) are block
// reductions by shuffles and shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// block-wide sum (is_max false) or max of one value a thread; every thread
// gets the result
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < kWarps ? red[lane] : (is_max ? -__int_as_float(0x7f800000) : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, u, o);
      u = is_max ? fmaxf(u, w) : __fadd_rn(u, w);
    }
    if (lane == 0) red[kWarps] = u;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

// (v, i) := the better of (v, i) and (v2, i2): the larger value, on a tie
// the lower index
__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
vit_head_kernel(const void* __restrict__ x, const float* __restrict__ lnf_s,
                const float* __restrict__ lnf_b, const float* __restrict__ hw,
                const float* __restrict__ hb, float* __restrict__ logits,
                float* __restrict__ probs, int* __restrict__ ids, int T, int D, int C, int K) {
  extern __shared__ float smem[];
  float* z = smem;      // [D] the [CLS] row, then ln_f's output
  float* pr = smem + D;  // [C] logits, then probabilities
  __shared__ float red[kWarps + 1];
  __shared__ int red_i[kWarps];
  const long long b = blockIdx.x;
  const float inv_d = 1.0f / static_cast<float>(D);

  // ln_f on the [CLS] row
  const long long off = b * T * D;
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = load_val(x, BF16 ? KIND_BF16 : KIND_F32, off + d);
    z[d] = v;
    s = __fadd_rn(s, v);
  }
  const float mean = __fmul_rn(block_reduce(s, red, false), inv_d);
  float sq = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float c = __fsub_rn(z[d], mean);
    z[d] = c;
    sq = __fadd_rn(sq, __fmul_rn(c, c));
  }
  const float r = __frsqrt_rn(__fadd_rn(__fmul_rn(block_reduce(sq, red, false), inv_d), 1e-5f));
  for (int d = threadIdx.x; d < D; d += kThreads)
    z[d] = rb<BF16>(ln_affine(z[d], r, lnf_s[d], lnf_b[d]));
  __syncthreads();

  // the head: logits in the compute dtype, widened to f32. With C a
  // multiple of 4 a thread takes four adjacent classes, its row reads 16
  // bytes wide (more bytes in flight from L2, four independent sums)
  float mx = -__int_as_float(0x7f800000);
  if (C % 4 == 0) {
    const float4* hw4 = reinterpret_cast<const float4*>(hw);
    const int C4 = C / 4;
    for (int g = threadIdx.x; g < C4; g += kThreads) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 w = hw4[static_cast<long long>(d) * C4 + g];
        const float zd = z[d];
        acc[0] = fmaf(zd, rb<BF16>(w.x), acc[0]);
        acc[1] = fmaf(zd, rb<BF16>(w.y), acc[1]);
        acc[2] = fmaf(zd, rb<BF16>(w.z), acc[2]);
        acc[3] = fmaf(zd, rb<BF16>(w.w), acc[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * g + j;
        const float l = rb<BF16>(__fadd_rn(rb<BF16>(acc[j]), rb<BF16>(hb[c])));
        logits[b * C + c] = l;
        pr[c] = l;
        mx = fmaxf(mx, l);
      }
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        acc = fmaf(z[d], rb<BF16>(hw[static_cast<long long>(d) * C + c]), acc);
      const float l = rb<BF16>(__fadd_rn(rb<BF16>(acc), rb<BF16>(hb[c])));
      logits[b * C + c] = l;
      pr[c] = l;
      mx = fmaxf(mx, l);
    }
  }
  if (K == 0) return;  // uniform across the block
  mx = block_reduce(mx, red, true);

  // softmax in f32
  float se = 0.0f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float e = expf(__fsub_rn(pr[c], mx));
    pr[c] = e;
    se = __fadd_rn(se, e);
  }
  const float sum = block_reduce(se, red, false);
  for (int c = threadIdx.x; c < C; c += kThreads) pr[c] = __fdiv_rn(pr[c], sum);
  __syncthreads();

  // top-k: K block-wide argmaxes; a taken class is struck out with -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < K; ++j) {
    float v = -2.0f;
    int i = 0x7fffffff;
    for (int c = threadIdx.x; c < C; c += kThreads) take_better(v, i, pr[c], c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
    if (lane == 0) {
      red[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) take_better(v, i, red[w], red_i[w]);
      probs[b * K + j] = v;
      ids[b * K + j] = i;
      if (i < C) pr[i] = -1.0f;  // i stays past C only if every p is NaN
    }
    __syncthreads();
  }
}

}  // namespace

// x: [B, T, D] (kind KIND_F32 or KIND_BF16; row 0 of each frame is read);
// lnf_s, lnf_b f32[D]; hw f32[D, C]; hb f32[C]; logits f32[B, C]; probs
// f32[B, K] and ids i32[B, K] (unused when K is 0); 0 <= K <= min(C, 64).
extern "C" int sw_vit_head(const void* x, const float* lnf_s, const float* lnf_b, const float* hw,
                           const float* hb, float* logits, float* probs, int* ids, int B, int T,
                           int D, int C, int K, int kind, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || D < 1 || C < 1 || K < 0 || K > C || K > 64 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(D + C) * sizeof(float);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == KIND_BF16) {
    err = cudaFuncSetAttribute(vit_head_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    vit_head_kernel<true><<<B, kThreads, smem, st>>>(x, lnf_s, lnf_b, hw, hb, logits, probs, ids,
                                                     T, D, C, K);
  } else {
    err = cudaFuncSetAttribute(vit_head_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    vit_head_kernel<false><<<B, kThreads, smem, st>>>(x, lnf_s, lnf_b, hw, hb, logits, probs, ids,
                                                      T, D, C, K);
  }
  return static_cast<int>(cudaGetLastError());
}
