// KA attention: scaled dot-product attention with an f32 softmax, per
// (sequence, head), heads split by column of [N, T, heads * hd] rows.
//
// Replaces sitewhere_tpu/models/common.py:61 attn_core as the transformer
// family's blocks call it (mha_stacked :308, transformer_block_stacked
// :329): q, k, v come in the compute dtype as the projections produce them;
// the QK^T product is accumulated in f32 and rounded to the compute dtype
// (the reference's einsum output), widened to f32 and scaled by
// 1/sqrt(hd) (XLA folds the reference's division into that product);
// causal rows see keys 0..i only (the reference's -1e30 mask gives the
// others exp() = 0); the softmax is exp(l - max) / sum in f32, each p
// rounded to the compute dtype; p.v is accumulated in f32 and rounded once
// into the output. Head dims 32 (the transformer) and 64 (ViT-B/16),
// T <= 512 where the staged rows fit 227 KB (smem_bytes): f32 at hd 64
// takes T <= 435, the other dtype and head dims 512 (models/common.py
// attn_max_t mirrors smem_bytes and refuses the rest before a launch).
//
// Bound on the H100: bytes at the transformer's shapes. One sequence of
// T=31 tokens x 128 columns moves 31.7 KB (q, k, v read, out written) for
// ~0.5 MFLOP, ~15 FLOP a byte, far below the card's ~295 bf16 FLOP a byte.
// Design: one block per (sequence, head), four warps. K and V of the head
// are staged in shared memory in the input dtype (K rows padded by one
// 32-bit word, so lanes reading one column of 32 different keys hit 32
// banks); a warp takes one query at a time: pass 1, each lane owns keys
// lane, lane+32, ... and writes its logits to the warp's row of shared
// memory, with the row max and the f32 sum of exp reduced by shuffles;
// pass 2, each lane owns hd/32 output columns and accumulates p.v over the
// keys. Two passes, not an online softmax: a running rescale could not
// round p where the reference rounds it.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// round to the compute dtype T
template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

// elements per K row in shared memory: hd plus one 32-bit word
template <typename T, int HD>
__host__ __device__ constexpr int k_stride() {
  return HD + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
size_t smem_bytes(int Tn) {
  const size_t kv = static_cast<size_t>(Tn) * (k_stride<T, HD>() + HD) * sizeof(T);
  const size_t kv_aligned = (kv + 15) / 16 * 16;
  return kv_aligned + static_cast<size_t>(kWarps) * (HD + Tn) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Tn, int D, int causal, float scale) {
  constexpr int KS = k_stride<T, HD>();
  constexpr int HQ = HD / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [Tn][KS]
  T* vs = ks + static_cast<size_t>(Tn) * KS;  // [Tn][HD]
  const size_t kv = static_cast<size_t>(Tn) * (KS + HD) * sizeof(T);
  float* qs = reinterpret_cast<float*>(smem_raw + (kv + 15) / 16 * 16);  // [kWarps][HD]
  float* ps = qs + kWarps * HD;                                          // [kWarps][Tn]

  const long long base = static_cast<long long>(blockIdx.x) * Tn * D + blockIdx.y * HD;
  for (int e = threadIdx.x; e < Tn * HD; e += blockDim.x) {
    const int t = e / HD, d = e % HD;
    ks[t * KS + d] = k[base + static_cast<long long>(t) * D + d];
    vs[t * HD + d] = v[base + static_cast<long long>(t) * D + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qs + warp * HD;
  float* pw = ps + warp * Tn;
  for (int i = warp; i < Tn; i += kWarps) {
    const long long row = base + static_cast<long long>(i) * D;
    for (int d = lane; d < HD; d += 32) qw[d] = to_f(q[row + d]);
    __syncwarp();
    const int nk = causal ? i + 1 : Tn;
    float mx = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < nk; j += 32) {
      const T* kr = ks + j * KS;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qw[d], to_f(kr[d]), acc);
      const float l = __fmul_rn(rc<T>(acc), scale);
      pw[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(__fsub_rn(pw[j], mx));
      pw[j] = e;
      sum = __fadd_rn(sum, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    for (int j = lane; j < nk; j += 32) pw[j] = rc<T>(__fdiv_rn(pw[j], sum));
    __syncwarp();
    float acc[HQ];
#pragma unroll
    for (int c = 0; c < HQ; ++c) acc[c] = 0.0f;
    for (int j = 0; j < nk; ++j) {
      const float p = pw[j];
      const T* vr = vs + j * HD + lane;
#pragma unroll
      for (int c = 0; c < HQ; ++c) acc[c] = fmaf(p, to_f(vr[32 * c]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < HQ; ++c) put(out + row + lane + 32 * c, acc[c]);
    __syncwarp();
  }
}

template <typename T, int HD>
int launch_ka(const void* q, const void* k, const void* v, void* out, int N, int Tn, int heads,
              int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(Tn);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const dim3 grid(N, heads);
  attention_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, heads * HD, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: [N, T, heads * hd] in the compute dtype (kind KIND_F32 or
// KIND_BF16); hd 32 or 64; 1 <= T <= 512.
extern "C" int sw_attention(const void* q, const void* k, const void* v, void* out, int N, int T,
                            int heads, int hd, int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || T > 512 || heads < 1 || heads > 65535 || (hd != 32 && hd != 64) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    return hd == 32 ? launch_ka<__nv_bfloat16, 32>(q, k, v, out, N, T, heads, causal, st)
                    : launch_ka<__nv_bfloat16, 64>(q, k, v, out, N, T, heads, causal, st);
  }
  return hd == 32 ? launch_ka<float, 32>(q, k, v, out, N, T, heads, causal, st)
                  : launch_ka<float, 64>(q, k, v, out, N, T, heads, causal, st);
}
