// KA attention_bwd: the backward of KA's scaled dot-product attention, per
// (sequence, head), heads split by column of [N, T, heads * hd] rows.
//
// Replaces the vjp of sitewhere_tpu/models/common.py:61 attn_core as
// jax.grad runs it through the transformer family's train loss
// (models/transformer.py:272 loss_stacked -> :229 _backbone_stacked ->
// common.py:329 transformer_block_stacked -> :308 mha_stacked): q, k, v
// and the output's cotangent dout in the compute dtype -> dq, dk, dv in
// the compute dtype. The rounding points are those of the reference's grad
// jaxpr and compiled HLO (bf16, causal):
//   dp = dout . v^T, accumulated in f32, rounded to the compute dtype;
//   the softmax's backward in the exp / sum form XLA differentiates:
//   a = sum_k (dp_k * (1 / s^2)) * e_k, dl = ((dp / s) - a) * e (f32,
//   e = exp(l - max), s = sum e), masked keys 0; XLA folds the division by
//   sqrt(hd) into a product by 1/sqrt(hd), then one rounding;
//   dq = dl . k, dk = dl^T . q and dv = p^T . dout, each accumulated in
//   f32 and rounded once, p = e / s rounded as the forward rounds it.
// p is not saved by the forward: the backward recomputes the logits, the
// max, the sum and p with the forward kernel's exact arithmetic (the same
// dot order, the same lane-strided sums and shuffle trees), so p here is
// bitwise the p of KA's forward, and the train form saves no T x T matrix
// (2.0 GB a block at transformer32's plane in bf16).
//
// Bound on the H100: bytes at the transformer's shapes. One sequence of
// T = 31 tokens x 128 columns reads q, k, v, dout and writes dq, dk, dv
// (7 x 7.9 KB in bf16) for ~1.5 MFLOP, ~27 FLOP a byte, far below the
// card's ~295 bf16 FLOP a byte.
// Design: one block per (sequence, head), four warps; Q, K, V and dout of
// the head staged in shared memory in the input dtype, every row padded
// by one 32-bit word (lanes reading one column of 32 different rows hit 32
// banks). Pass 1, a warp per query i as in the forward: each lane owns
// keys lane, lane+32, ...: the logits, max and sum as the forward, then
// dp, the Sigma term a by a shuffle tree, dl; then each lane owns hd/32
// columns of dq_i. The row's max, sum and a go to shared memory. Pass 2, a
// warp per key j: each lane owns queries i (i >= j when causal), recomputes
// p_ij and dl_ij from the saved row statistics, and then each lane owns
// hd/32 columns of dk_j and dv_j. Head dims 32 and 64, T <= 512 where the
// staged rows fit the 227 KB of shared memory (smem_bytes): T <= 209 in
// f32 at hd 64 (ViT-B/16's T 197 takes 218,748 bytes), 391 in bf16 at hd
// 64, 393 in f32 at hd 32, 512 in bf16 at hd 32 (models/common.py
// attn_max_t mirrors smem_bytes and refuses the rest before a launch).
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

// elements per staged row in shared memory: hd plus one 32-bit word
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
size_t smem_bytes(int Tn) {
  const size_t mats = 4 * static_cast<size_t>(Tn) * row_stride<T, HD>() * sizeof(T);
  return (mats + 15) / 16 * 16 +
         (static_cast<size_t>(kWarps) * (2 * HD + 3 * Tn) + 3 * static_cast<size_t>(Tn)) *
             sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, int Tn, int D, int causal, float scale) {
  constexpr int RS = row_stride<T, HD>();
  constexpr int HQ = HD / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [Tn][RS] each
  T* ks = qs + static_cast<size_t>(Tn) * RS;
  T* vs = ks + static_cast<size_t>(Tn) * RS;
  T* os = vs + static_cast<size_t>(Tn) * RS;
  const size_t mats = 4 * static_cast<size_t>(Tn) * RS * sizeof(T);
  float* fbuf = reinterpret_cast<float*>(smem_raw + (mats + 15) / 16 * 16);
  float* smx = fbuf;                   // [Tn] row max
  float* ssum = smx + Tn;              // [Tn] row sum of e
  float* sa = ssum + Tn;               // [Tn] row Sigma term
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = sa + Tn + warp * (2 * HD + 3 * Tn);  // [HD] the query row, f32
  float* ow = qw + HD;                             // [HD] its dout row
  float* ew = ow + HD;                             // [Tn] logits, then e; pass 2: p
  float* dpw = ew + Tn;                            // [Tn] dp
  float* dlw = dpw + Tn;                           // [Tn] dl (rounded)

  const long long base = static_cast<long long>(blockIdx.x) * Tn * D + blockIdx.y * HD;
  for (int e = threadIdx.x; e < Tn * HD; e += blockDim.x) {
    const int t = e / HD, d = e % HD;
    const long long g = base + static_cast<long long>(t) * D + d;
    qs[t * RS + d] = q[g];
    ks[t * RS + d] = k[g];
    vs[t * RS + d] = v[g];
    os[t * RS + d] = dout[g];
  }
  __syncthreads();

  // pass 1: a warp per query
  for (int i = warp; i < Tn; i += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      qw[d] = to_f(qs[i * RS + d]);
      ow[d] = to_f(os[i * RS + d]);
    }
    __syncwarp();
    const int nk = causal ? i + 1 : Tn;
    float mx = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < nk; j += 32) {
      const T* kr = ks + j * RS;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qw[d], to_f(kr[d]), acc);
      const float l = __fmul_rn(rc<T>(acc), scale);
      ew[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(__fsub_rn(ew[j], mx));
      ew[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    const float is2 = __fdiv_rn(1.0f, __fmul_rn(sum, sum));
    float a = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const T* vr = vs + j * RS;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(ow[d], to_f(vr[d]), acc);
      const float dp = rc<T>(acc);
      dpw[j] = dp;
      a = __fadd_rn(a, __fmul_rn(__fmul_rn(dp, is2), ew[j]));
    }
    a = warp_sum(a);
    for (int j = lane; j < nk; j += 32) {
      const float dl = __fmul_rn(__fadd_rn(__fdiv_rn(dpw[j], sum), -a), ew[j]);
      dlw[j] = rc<T>(__fmul_rn(dl, scale));
    }
    if (lane == 0) {
      smx[i] = mx;
      ssum[i] = sum;
      sa[i] = a;
    }
    __syncwarp();
    float acc[HQ];
#pragma unroll
    for (int c = 0; c < HQ; ++c) acc[c] = 0.0f;
    for (int j = 0; j < nk; ++j) {
      const float w = dlw[j];
      const T* kr = ks + j * RS + lane;
#pragma unroll
      for (int c = 0; c < HQ; ++c) acc[c] = fmaf(w, to_f(kr[32 * c]), acc[c]);
    }
    const long long row = base + static_cast<long long>(i) * D;
#pragma unroll
    for (int c = 0; c < HQ; ++c) put(dq + row + lane + 32 * c, acc[c]);
    __syncwarp();
  }
  __syncthreads();

  // pass 2: a warp per key
  for (int j = warp; j < Tn; j += kWarps) {
    const int i0 = causal ? j : 0;
    const T* kr = ks + j * RS;
    const T* vr = vs + j * RS;
    for (int i = i0 + lane; i < Tn; i += 32) {
      const T* qr = qs + i * RS;
      const T* orow = os + i * RS;
      float acc = 0.0f, acc2 = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        acc = fmaf(to_f(qr[d]), to_f(kr[d]), acc);
        acc2 = fmaf(to_f(orow[d]), to_f(vr[d]), acc2);
      }
      const float l = __fmul_rn(rc<T>(acc), scale);
      const float e = expf(__fsub_rn(l, smx[i]));
      ew[i] = rc<T>(__fdiv_rn(e, ssum[i]));
      const float dp = rc<T>(acc2);
      const float dl = __fmul_rn(__fadd_rn(__fdiv_rn(dp, ssum[i]), -sa[i]), e);
      dlw[i] = rc<T>(__fmul_rn(dl, scale));
    }
    __syncwarp();
    float av[HQ], ak[HQ];
#pragma unroll
    for (int c = 0; c < HQ; ++c) av[c] = ak[c] = 0.0f;
    for (int i = i0; i < Tn; ++i) {
      const float p = ew[i], w = dlw[i];
      const T* orow = os + i * RS + lane;
      const T* qr = qs + i * RS + lane;
#pragma unroll
      for (int c = 0; c < HQ; ++c) {
        av[c] = fmaf(p, to_f(orow[32 * c]), av[c]);
        ak[c] = fmaf(w, to_f(qr[32 * c]), ak[c]);
      }
    }
    const long long row = base + static_cast<long long>(j) * D;
#pragma unroll
    for (int c = 0; c < HQ; ++c) {
      put(dv + row + lane + 32 * c, av[c]);
      put(dk + row + lane + 32 * c, ak[c]);
    }
    __syncwarp();
  }
}

template <typename T, int HD>
int launch_kab(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int N, int Tn, int heads, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(Tn);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const dim3 grid(N, heads);
  attention_bwd_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      Tn, heads * HD, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [N, T, heads * hd] in the compute dtype (kind
// KIND_F32 or KIND_BF16); hd 32 or 64; 1 <= T <= 512 (and the staged rows
// within 227 KB of shared memory).
extern "C" int sw_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, int N, int T, int heads, int hd,
                                int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || T > 512 || heads < 1 || heads > 65535 || (hd != 32 && hd != 64) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    return hd == 32
               ? launch_kab<__nv_bfloat16, 32>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st)
               : launch_kab<__nv_bfloat16, 64>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st);
  }
  return hd == 32 ? launch_kab<float, 32>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st)
                  : launch_kab<float, 64>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st);
}

