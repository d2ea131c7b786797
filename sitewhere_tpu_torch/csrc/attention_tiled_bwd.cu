// KA's backward, tiled form: the backward of attention_tiled.cu at any head
// dim from 1 to 256 and any sequence length, its shared memory independent
// of T. Heads are split by column of [N, T, heads * hd] rows.
//
// Replaces the vjp of sitewhere_tpu/models/common.py:61 attn_core under
// jax.grad (the transformer's loss_stacked, the ViT's loss) where the
// staged backward (attention_bwd.cu: hd 32 and 64, Q, K, V and dout of all
// T rows in shared memory) does not take the shape. The rounding points
// are attention_bwd.cu's: dp = dout . v^T accumulated in f32 and rounded;
// the Sigma term a = sum_k (dp_k * (1 / s^2)) * e_k; dl = ((dp / s) - a) *
// e times 1/sqrt(hd), rounded (e = exp(l - max), s = sum e, masked keys
// 0); dq = dl . k, dk = dl^T . q and dv = p^T . dout, each accumulated in
// f32 and rounded once, p = rc(e / s) as the forward rounds it.
//
// Design, FlashAttention-2's split in two kernels, no atomics (two runs are
// bitwise equal), p never stored:
//   1. dQ, one block per (sequence, head, query tile), four warps of RW
//      rows each, key and value tiles of 32 streamed through shared memory
//      (a lane a key for the dot products, a lane hd/32 columns for dq):
//      pass 1 the row's max and sum (online, as the forward), pass 2 the
//      Sigma term, pass 3 dl and dq; the rows' (max, sum, a) go to a
//      stats buffer f32[N, heads, T, 3].
//   2. dK and dV, one block per (sequence, head, key tile), four warps of
//      RW keys each; query tiles of 32 (and their dout rows) stream
//      through shared memory, a lane a query: p and dl recomputed from the
//      stats, then a lane hd/32 columns of dk and dv. A causal key tile
//      starts at its first key's query.
//
// Bound on the H100: bytes or operations by shape; at ViT-B/16 at 384 (64
// x 577 x 12 x 64, bf16) it reads q, k, v, dout and writes dq, dk, dv,
// 199 MB (0.059 ms), and does 8 T^2 hd FLOP a (sequence, head) (0.13 ms
// at the bf16 tensor rate). This form recomputes the logits in both
// kernels on CUDA cores; tensor-core tiles are the open speed work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;  // keys (kernel 1) or queries (kernel 2) a streamed tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

template <int HQ>
struct Tiles {
  static constexpr int HDM = 32 * HQ;
  static constexpr int RS = HDM + 4;  // padded row stride of a streamed tile
  static constexpr int RW = 16 / HQ;  // rows (kernel 1) or keys (kernel 2) a warp
  static constexpr int BR = kWarps * RW;
};

template <int HQ>
size_t dq_smem_bytes() {
  using S = Tiles<HQ>;
  return (2 * static_cast<size_t>(kTile) * S::RS + 2 * static_cast<size_t>(S::BR) * S::HDM +
          static_cast<size_t>(kWarps) * S::RW * kTile) *
         sizeof(float);
}

template <int HQ>
size_t dkv_smem_bytes() {
  using S = Tiles<HQ>;
  return (2 * static_cast<size_t>(S::BR) * S::HDM + 2 * static_cast<size_t>(kTile) * S::RS +
          2 * static_cast<size_t>(kWarps) * S::RW * kTile) *
         sizeof(float);
}

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ x, long long base,
                                           int j0, int n, int valid, int hd, int hdm, int stride,
                                           int D) {
  for (int e = threadIdx.x; e < n * hdm; e += blockDim.x) {
    const int r = e / hdm, d = e - r * hdm;
    const int j = j0 + r;
    dst[r * stride + d] =
        (j < valid && d < hd) ? to_f(x[base + static_cast<long long>(j) * D + d]) : 0.0f;
  }
}

// f32 dot products of RW rows a (stride HDM, shared by the warp) with one
// row b per lane, d ascending over hd4 (the padding is 0): the same
// arithmetic as attention_tiled.cu's, so the logits are bitwise its own.
template <int HQ>
__device__ __forceinline__ void row_dots(const float* a, const float* b, int hd4,
                                         float (&l)[Tiles<HQ>::RW]) {
  using S = Tiles<HQ>;
#pragma unroll
  for (int r = 0; r < S::RW; ++r) l[r] = 0.0f;
  for (int d = 0; d < hd4; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int r = 0; r < S::RW; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(a + r * S::HDM + d);
      l[r] = fmaf(av.x, bv.x, l[r]);
      l[r] = fmaf(av.y, bv.y, l[r]);
      l[r] = fmaf(av.z, bv.z, l[r]);
      l[r] = fmaf(av.w, bv.w, l[r]);
    }
  }
}

// The same products with the roles swapped: RW rows b (stride HDM, shared)
// against the lane's row a, so l[r] = a . b_r in row_dots' order.
template <int HQ>
__device__ __forceinline__ void lane_dots(const float* a, const float* b, int hd4,
                                          float (&l)[Tiles<HQ>::RW]) {
  using S = Tiles<HQ>;
#pragma unroll
  for (int r = 0; r < S::RW; ++r) l[r] = 0.0f;
  for (int d = 0; d < hd4; d += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + d);
#pragma unroll
    for (int r = 0; r < S::RW; ++r) {
      const float4 bv = *reinterpret_cast<const float4*>(b + r * S::HDM + d);
      l[r] = fmaf(bv.x, av.x, l[r]);
      l[r] = fmaf(bv.y, av.y, l[r]);
      l[r] = fmaf(bv.z, av.z, l[r]);
      l[r] = fmaf(bv.w, av.w, l[r]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv; float* stats;
  int Tn; int D; int hd; int causal; float scale; int tiles;
};

// kernel 1: dq and the rows' statistics
template <typename T, int HQ>
__global__ void __launch_bounds__(kWarps * 32)
attention_tiled_dq(const Args a) {
  using S = Tiles<HQ>;
  constexpr int HDM = S::HDM, RS = S::RS, RW = S::RW, BR = S::BR;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                  // [kTile][RS]
  float* vs = ks + kTile * RS;     // [kTile][RS]
  float* qs = vs + kTile * RS;     // [BR][HDM]
  float* os = qs + BR * HDM;       // [BR][HDM] dout
  float* dls = os + BR * HDM;      // [kWarps][RW][kTile]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd4 = (hd + 3) & ~3;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(blockIdx.y) * hd;
  const long long sbase = (static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) * Tn;
  float* dw = dls + warp * RW * kTile;
  const float* qw = qs + warp * RW * HDM;
  const float* ow = os + warp * RW * HDM;
  const float ninf = -__int_as_float(0x7f800000);

  for (int qt = blockIdx.z; qt < a.tiles; qt += gridDim.z) {
    const int q0 = qt * BR;
    const int i0 = q0 + warp * RW;
    __syncthreads();
    for (int e = threadIdx.x; e < BR * HDM; e += blockDim.x) {
      const int r = e / HDM, d = e - r * HDM;
      const long long g = base + static_cast<long long>(min(q0 + r, Tn - 1)) * D + d;
      qs[e] = d < hd ? to_f(q[g]) : 0.0f;
      os[e] = d < hd ? to_f(dout[g]) : 0.0f;
    }
    const int nk = causal ? min(q0 + BR, Tn) : Tn;
    float mx[RW], sum[RW], sg[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      mx[r] = ninf;
      sum[r] = 0.0f;
      sg[r] = 0.0f;
    }
    // pass 1: max and sum
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kTile, nk, hd, HDM, RS, D);
      __syncthreads();
      float l[RW];
      row_dots<HQ>(qw, ks + lane * RS, hd4, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = ok ? __fmul_rn(rc<T>(l[r]), scale) : ninf;
        const float nm = fmaxf(mx[r], warp_max(lr));
        const float e = ok ? expf(__fsub_rn(lr, nm)) : 0.0f;
        sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), warp_sum(e));
        mx[r] = nm;
      }
    }
    float is2[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) is2[r] = __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r]));
    // pass 2: the Sigma term, each lane over its keys, then the warp's sum
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kTile, nk, hd, HDM, RS, D);
      stage_rows(vs, v, base, j0, kTile, nk, hd, HDM, RS, D);
      __syncthreads();
      float l[RW], dp[RW];
      row_dots<HQ>(qw, ks + lane * RS, hd4, l);
      row_dots<HQ>(ow, vs + lane * RS, hd4, dp);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        if (j < nk && (!causal || j <= i)) {
          const float e = expf(__fsub_rn(__fmul_rn(rc<T>(l[r]), scale), mx[r]));
          sg[r] = __fadd_rn(sg[r], __fmul_rn(__fmul_rn(rc<T>(dp[r]), is2[r]), e));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) sg[r] = warp_sum(sg[r]);
    // pass 3: dl and dq
    float acc[RW][HQ];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < HQ; ++c) acc[r][c] = 0.0f;
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kTile, nk, hd, HDM, RS, D);
      stage_rows(vs, v, base, j0, kTile, nk, hd, HDM, RS, D);
      __syncthreads();
      float l[RW], dp[RW];
      row_dots<HQ>(qw, ks + lane * RS, hd4, l);
      row_dots<HQ>(ow, vs + lane * RS, hd4, dp);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        float w = 0.0f;
        if (j < nk && (!causal || j <= i)) {
          const float e = expf(__fsub_rn(__fmul_rn(rc<T>(l[r]), scale), mx[r]));
          const float dl = __fmul_rn(__fadd_rn(__fdiv_rn(rc<T>(dp[r]), sum[r]), -sg[r]), e);
          w = rc<T>(__fmul_rn(dl, scale));
        }
        dw[r * kTile + lane] = w;
      }
      __syncwarp();
      const int kn = min(kTile, nk - j0);
      for (int jj = 0; jj < kn; ++jj) {
        float kv[HQ];
#pragma unroll
        for (int c = 0; c < HQ; ++c) kv[c] = ks[jj * RS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float w = dw[r * kTile + jj];
#pragma unroll
          for (int c = 0; c < HQ; ++c) acc[r][c] = fmaf(w, kv[c], acc[r][c]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = i0 + r;
      if (i >= Tn) continue;
      const long long row = base + static_cast<long long>(i) * D;
#pragma unroll
      for (int c = 0; c < HQ; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) put(static_cast<T*>(a.dq) + row + d, acc[r][c]);
      }
      if (lane == 0) {
        float* st = a.stats + (sbase + i) * 3;
        st[0] = mx[r];
        st[1] = sum[r];
        st[2] = sg[r];
      }
    }
  }
}

// kernel 2: dk and dv
template <typename T, int HQ>
__global__ void __launch_bounds__(kWarps * 32)
attention_tiled_dkv(const Args a) {
  using S = Tiles<HQ>;
  constexpr int HDM = S::HDM, RS = S::RS, RW = S::RW, BR = S::BR;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                  // [BR][HDM] the block's keys
  float* vs = ks + BR * HDM;       // [BR][HDM] their values
  float* qs = vs + BR * HDM;       // [kTile][RS] a query tile
  float* os = qs + kTile * RS;     // [kTile][RS] its dout rows
  float* pb = os + kTile * RS;     // [kWarps][RW][kTile] p
  float* lb = pb + kWarps * RW * kTile;  // [kWarps][RW][kTile] dl (rounded)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd4 = (hd + 3) & ~3;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(blockIdx.y) * hd;
  const long long sbase = (static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) * Tn;
  float* pw = pb + warp * RW * kTile;
  float* lw = lb + warp * RW * kTile;
  const float* kw = ks + warp * RW * HDM;
  const float* vw = vs + warp * RW * HDM;

  for (int kt = blockIdx.z; kt < a.tiles; kt += gridDim.z) {
    const int k0 = kt * BR;
    const int j0 = k0 + warp * RW;  // the warp's first key
    __syncthreads();
    for (int e = threadIdx.x; e < BR * HDM; e += blockDim.x) {
      const int r = e / HDM, d = e - r * HDM;
      const long long g = base + static_cast<long long>(min(k0 + r, Tn - 1)) * D + d;
      ks[e] = d < hd ? to_f(k[g]) : 0.0f;
      vs[e] = d < hd ? to_f(v[g]) : 0.0f;
    }
    float av[RW][HQ], ak[RW][HQ];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < HQ; ++c) av[r][c] = ak[r][c] = 0.0f;
    for (int i0 = causal ? k0 : 0; i0 < Tn; i0 += kTile) {
      __syncthreads();
      stage_rows(qs, q, base, i0, kTile, Tn, hd, HDM, RS, D);
      stage_rows(os, dout, base, i0, kTile, Tn, hd, HDM, RS, D);
      __syncthreads();
      const int i = i0 + lane;
      float mx = 0.0f, sum = 1.0f, sg = 0.0f;
      if (i < Tn) {
        const float* st = a.stats + (sbase + i) * 3;
        mx = st[0];
        sum = st[1];
        sg = st[2];
      }
      float l[RW], dp[RW];
      lane_dots<HQ>(qs + lane * RS, kw, hd4, l);
      lane_dots<HQ>(os + lane * RS, vw, hd4, dp);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int j = j0 + r;
        float p = 0.0f, w = 0.0f;
        if (i < Tn && j < Tn && (!causal || i >= j)) {
          const float e = expf(__fsub_rn(__fmul_rn(rc<T>(l[r]), scale), mx));
          p = rc<T>(__fdiv_rn(e, sum));
          const float dl = __fmul_rn(__fadd_rn(__fdiv_rn(rc<T>(dp[r]), sum), -sg), e);
          w = rc<T>(__fmul_rn(dl, scale));
        }
        pw[r * kTile + lane] = p;
        lw[r * kTile + lane] = w;
      }
      __syncwarp();
      const int qn = min(kTile, Tn - i0);
      for (int ii = 0; ii < qn; ++ii) {
        float ov[HQ], qv[HQ];
#pragma unroll
        for (int c = 0; c < HQ; ++c) {
          ov[c] = os[ii * RS + lane + 32 * c];
          qv[c] = qs[ii * RS + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float p = pw[r * kTile + ii], w = lw[r * kTile + ii];
#pragma unroll
          for (int c = 0; c < HQ; ++c) {
            av[r][c] = fmaf(p, ov[c], av[r][c]);
            ak[r][c] = fmaf(w, qv[c], ak[r][c]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int j = j0 + r;
      if (j >= Tn) continue;
      const long long row = base + static_cast<long long>(j) * D;
#pragma unroll
      for (int c = 0; c < HQ; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          put(static_cast<T*>(a.dv) + row + d, av[r][c]);
          put(static_cast<T*>(a.dk) + row + d, ak[r][c]);
        }
      }
    }
  }
}

template <typename T, int HQ>
int launch_tiled_bwd(Args a, int N, int heads, cudaStream_t stream) {
  using S = Tiles<HQ>;
  const size_t s1 = dq_smem_bytes<HQ>(), s2 = dkv_smem_bytes<HQ>();
  cudaError_t err = cudaFuncSetAttribute(attention_tiled_dq<T, HQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_tiled_dkv<T, HQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.hd)));
  a.tiles = (a.Tn + S::BR - 1) / S::BR;
  const dim3 grid(N, heads, a.tiles < 65535 ? a.tiles : 65535);
  attention_tiled_dq<T, HQ><<<grid, kWarps * 32, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_tiled_dkv<T, HQ><<<grid, kWarps * 32, s2, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(const Args& a, int N, int heads, cudaStream_t st) {
  if (a.hd <= 32) return launch_tiled_bwd<T, 1>(a, N, heads, st);
  if (a.hd <= 64) return launch_tiled_bwd<T, 2>(a, N, heads, st);
  if (a.hd <= 128) return launch_tiled_bwd<T, 4>(a, N, heads, st);
  return launch_tiled_bwd<T, 8>(a, N, heads, st);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [N, T, heads * hd] in the compute dtype (kind
// KIND_F32 or KIND_BF16); stats: f32[N, heads, T, 3] scratch; 1 <= hd <=
// 256; any T >= 1. Launches kernel 1 (dq), then kernel 2 (dk, dv).
extern "C" int sw_attention_tiled_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      float* stats, int N, int T, int heads, int hd, int causal,
                                      int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || T < 1 || heads < 1 || heads > 65535 || hd < 1 || hd > 256 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, dout, dq, dk, dv, stats, T, heads * hd, hd, causal, 0.0f, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? by_head_dim<__nv_bfloat16>(a, N, heads, st)
                           : by_head_dim<float>(a, N, heads, st);
}
