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
//   1. dQ, one block per (sequence, head, query tile): pass 1 the row's max
//      and sum (online, as the forward), pass 2 the Sigma term, pass 3 dl
//      and dq; the rows' (max, sum, a) go to a stats buffer f32[N, heads,
//      T, 3].
//   2. dK and dV, one block per (sequence, head, key tile), the query tiles
//      (their dout rows and statistics) streamed: p and dl recomputed from
//      the stats, then dk and dv. A causal key tile starts at its first
//      key's query.
//
// Bound on the H100: at ViT-B/16 at 384 (64 x 577 x 12 x 64, bf16) it
// reads q, k, v, dout and writes dq, dk, dv, 397 MB (0.118 ms at 3.35
// TB/s), and does 5 products of 2 T^2 hd FLOP a (sequence, head), 164
// GFLOP (0.165 ms at the bf16 tensor rate): operations bound it.
//
// bf16 (attention_tiled_dq_tc, attention_tiled_dkv_tc): every product on
// the tensor cores (wgmma m64nNk16, bf16 in, f32 accumulators), a block two
// warpgroups of 64 rows (query rows in kernel 1, keys in kernel 2) sharing
// the tiles streamed through a ring of shared-memory stages (cp.async, the
// next tiles in flight under the current products); kernel 1 runs its three
// passes as one sequence of steps through the ring. Kernel 2 takes k . q^T
// and v . dout^T with its keys as the rows, so p^T and dl^T come out as
// accumulators and pass in registers to dv += p^T . dout and dk += dl^T . q
// (mma_tiles.cuh), as kernel 1's dl passes to dq += dl . k. The work is ten
// products against the bound's five: the logits in both kernels and in
// each of kernel 1's passes, dp in both kernels. Every product's shape is a
// compile-time constant (head dims below the instantiation's width run on
// zero columns), so the products stay in flight together.
//
// f32 (attention_tiled_dq, attention_tiled_dkv): CUDA cores, four warps of
// RW rows (kernel 1) or keys (kernel 2), tiles of 32 streamed through shared
// memory in f32, a lane a key (or query) for the dot products and hd/32
// columns for the accumulations. f32 products stay off the tensor cores:
// TF32 would miss the 2e-4 bar against float64.
#include <cmath>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;  // keys (kernel 1) or queries (kernel 2) a streamed tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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

// ---- the bf16 instance: tensor cores ----------------------------------------
//
// HDM the widest head dim of the instantiation (32, 64, 128, 256), the
// tiles' column count; a block is WG warpgroups of four warps, 64 rows a
// warpgroup (16 a warp), sharing the streamed tiles. Kernel 1: BQ query
// rows a block, key/value tiles of BK in a ring of NS stages. Kernel 2: BJ
// keys a block, query/dout tiles of BI in a ring of NS stages with their
// rows' statistics, the block's dk and dv columns [c0, c0 + DC) (column
// chunks of 64 past hd 64, so the accumulators stay in registers).
template <int HDM>
struct TcTiles {
  static constexpr int WG = 2;
  static constexpr int BQ = 64 * WG;
  static constexpr int BK = HDM > 128 ? 32 : 64;
  static constexpr int BJ = 64 * WG;
  static constexpr int BI = HDM > 128 ? 32 : 64;
  static constexpr int NS = 3;
  static constexpr int DC = HDM > 64 ? 64 : HDM;
  static constexpr int SC1 = BK / 8;  // 8-key chunks of kernel 1's logit tile
  static constexpr int SC2 = BI / 8;  // 8-query chunks of kernel 2's
};

template <int HDM>
size_t tc_dq_smem_bytes() {
  using S = TcTiles<HDM>;
  return static_cast<size_t>(2 * S::BQ + 2 * S::NS * S::BK) * HDM * sizeof(__nv_bfloat16);
}

template <int HDM>
size_t tc_dkv_smem_bytes() {
  using S = TcTiles<HDM>;
  return static_cast<size_t>(2 * S::BJ + 2 * S::NS * S::BI) * HDM * sizeof(__nv_bfloat16) +
         S::NS * 3 * static_cast<size_t>(S::BI) * sizeof(float);
}

// both products of a tile, q . k^T and dout . v^T, issued together
template <int HDM, int C>
__device__ __forceinline__ void two_dots(float (&s)[C][4], float (&dp)[C][4], const mt::bf16* qs,
                                         const mt::bf16* ks, const mt::bf16* os,
                                         const mt::bf16* vs) {
  mt::wg_fence();
#pragma unroll
  for (int kc = 0; kc < HDM / 16; ++kc) {
    if constexpr (C == 8) {
      mt::wg_ss64(&s[0][0], mt::kdesc<HDM>(qs, 0, kc), mt::kdesc<HDM>(ks, 0, kc), kc);
      mt::wg_ss64(&dp[0][0], mt::kdesc<HDM>(os, 0, kc), mt::kdesc<HDM>(vs, 0, kc), kc);
    } else {
      mt::wg_ss32(&s[0][0], mt::kdesc<HDM>(qs, 0, kc), mt::kdesc<HDM>(ks, 0, kc), kc);
      mt::wg_ss32(&dp[0][0], mt::kdesc<HDM>(os, 0, kc), mt::kdesc<HDM>(vs, 0, kc), kc);
    }
  }
  mt::wg_commit();
  mt::wg_wait();
  mt::pin(s);
  mt::pin(dp);
}

// kernel 1: dq and the rows' statistics, three passes over the key tiles
// run as one sequence of steps through the ring. Pass 1 the row's max and
// sum (online, the forward's arithmetic), pass 2 the Sigma term from q .
// k^T and dout . v^T, pass 3 dl = rc(((dp / s) - a) e / sqrt(hd)) in the
// logits' registers and dq += dl . k.
template <int HDM>
__global__ void __launch_bounds__(TcTiles<HDM>::WG * 128)
attention_tiled_dq_tc(const Args a, long long tiles, int vec) {
  using S = TcTiles<HDM>;
  using mt::bf16;
  constexpr int BQ = S::BQ, BK = S::BK, NS = S::NS, SC = S::SC1, OC = HDM / 8;
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* qs = reinterpret_cast<bf16*>(smraw);  // [BQ] rows
  bf16* os = qs + BQ * HDM;                   // [BQ] rows of dout
  bf16* ks = os + BQ * HDM;                   // [NS][BK] rows
  bf16* vs = ks + NS * BK * HDM;              // [NS][BK] rows
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int heads = D / hd;
  const float ninf = -__int_as_float(0x7f800000);
  const int g64 = (warp >> 2) * 64 * HDM;  // the warpgroup's 64 rows of qs, os

  // blocks in (sequence, head, query tile) order, the query tile fastest
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int qt = static_cast<int>(b % a.tiles);
    const long long sh = b / a.tiles;
    const long long base = (sh / heads) * Tn * D + (sh % heads) * hd;
    const long long sbase = sh * Tn;
    const int q0 = qt * BQ;
    const int w0 = q0 + warp * 16;
    const bool live = w0 < Tn;
    const int i_lo = min(w0 + (lane >> 2), Tn - 1), i_hi = min(w0 + (lane >> 2) + 8, Tn - 1);
    const int nk = causal ? min(q0 + BQ, Tn) : Tn;
    const int kend = causal ? min(min(w0 + 16, Tn), nk) : nk;
    const int ntiles = (nk + BK - 1) / BK, nsteps = 3 * ntiles;
    const int qc = (lane & 3) * 2;
    auto full = [&](int j0) { return causal ? j0 + BK - 1 <= w0 : j0 + BK <= Tn; };
    auto lim = [&](int j0, int i) { return (causal ? i : Tn - 1) - j0 - qc; };
    // step st: key tile st % ntiles of pass st / ntiles, with its value
    // tile past pass 1
    auto load_step = [&](int st) {
      const int j0 = (st % ntiles) * BK, at = (st % NS) * BK * HDM;
      mt::load_tile<HDM>(ks + at, k, base, j0, BK, nk, hd, D, vec);
      if (st >= ntiles) mt::load_tile<HDM>(vs + at, v, base, j0, BK, nk, hd, D, vec);
    };

    __syncthreads();
    mt::load_tile<HDM>(qs, q, base, q0, BQ, Tn, hd, D, vec);
    mt::load_tile<HDM>(os, dout, base, q0, BQ, Tn, hd, D, vec);
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < nsteps) load_step(st);
      mt::cp_commit();
    }
    float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f}, is2[2], rs[2];
    float acc[OC][4];
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
    for (int st = 0; st < nsteps; ++st) {
      if (st + NS - 1 < nsteps) load_step(st + NS - 1);
      mt::cp_commit();
      mt::cp_wait<NS - 1>();
      __syncthreads();
      const int pass = st / ntiles, j0 = (st - pass * ntiles) * BK;
      const bf16* kt = ks + (st % NS) * BK * HDM;
      const bf16* vt = vs + (st % NS) * BK * HDM;
      float s[SC][4], dp[SC][4];
      if (pass == 0) {
        // pass 1: max and sum
        mt::dots<HDM, SC>(s, qs + g64, kt);
        if (live && j0 < kend) {
          mt::scale_logits(s, full(j0), lim(j0, i_lo), lim(j0, i_hi), scale);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float tm = ninf;
#pragma unroll
            for (int c = 0; c < SC; ++c) tm = fmaxf(tm, fmaxf(s[c][2 * r], s[c][2 * r + 1]));
            const float nm = fmaxf(mx[r], mt::quad_max(tm));
            float part = 0.0f;  // a dropped key adds exp(-inf) = 0
#pragma unroll
            for (int c = 0; c < SC; ++c)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e)
                part = __fadd_rn(part, expf(__fsub_rn(s[c][e], nm)));
            sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), mt::quad_sum(part));
            mx[r] = nm;
          }
        }
      } else {
        // the tile's scaled logits (-inf where dropped) and rc(dp)
        two_dots<HDM, SC>(s, dp, qs + g64, kt, os + g64, vt);
        mt::scale_logits(s, full(j0), lim(j0, i_lo), lim(j0, i_hi), scale);
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          mt::rc2(dp[c][0], dp[c][1]);
          mt::rc2(dp[c][2], dp[c][3]);
        }
        if (pass == 1) {
          // pass 2: the Sigma term, each lane over its keys, then the quad's
          // sum (a dropped key adds (dp / s^2) exp(-inf) = 0)
          if (j0 == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) is2[r] = __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r]));
          }
          if (live && j0 < kend) {
#pragma unroll
            for (int c = 0; c < SC; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                sg[r] = __fadd_rn(sg[r], __fmul_rn(__fmul_rn(dp[c][e], is2[r]),
                                                   expf(__fsub_rn(s[c][e], mx[r]))));
              }
          }
        } else {
          // pass 3: dl and dq
          if (j0 == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              sg[r] = mt::quad_sum(sg[r]);
              rs[r] = mt::rcp(sum[r]);
            }
          }
#pragma unroll
          for (int c = 0; c < SC; ++c)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int r = e >> 1;
              float w[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float ex = expf(__fsub_rn(s[c][e + h], mx[r]));
                w[h] = __fmul_rn(
                    __fmul_rn(__fadd_rn(mt::div(dp[c][e + h], sum[r], rs[r]), -sg[r]), ex),
                    scale);
              }
              mt::rc2(w[0], w[1]);
              s[c][e] = s[c][e] == ninf ? 0.0f : w[0];
              s[c][e + 1] = s[c][e + 1] == ninf ? 0.0f : w[1];
            }
          mt::mul_acc<HDM, OC, BK / 16>(acc, s, kt, 0);
        }
      }
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = w0 + (lane >> 2) + (e >> 1) * 8;
          const int d = c * 8 + (lane & 3) * 2 + (e & 1);
          if (i < Tn && d < hd)
            static_cast<bf16*>(a.dq)[base + static_cast<long long>(i) * D + d] =
                __float2bfloat16_rn(acc[c][e]);
        }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = w0 + (lane >> 2) + r * 8;
          if (i < Tn) {
            float* st = a.stats + (sbase + i) * 3;
            st[0] = mx[r];
            st[1] = sum[r];
            st[2] = sg[r];
          }
        }
      }
    }
  }
}

// kernel 2: dk and dv. The block's 64 keys are the rows of k . q^T and v .
// dout^T over a query tile, so p^T and dl^T come out as accumulators with
// the keys as rows: the register A operands of dv += p^T . dout and dk +=
// dl^T . q. A causal key tile starts at its first key's query.
template <int HDM>
__global__ void __launch_bounds__(TcTiles<HDM>::WG * 128)
attention_tiled_dkv_tc(const Args a, long long tiles, int vec, int nch) {
  using S = TcTiles<HDM>;
  using mt::bf16;
  constexpr int BJ = S::BJ, BI = S::BI, DC = S::DC, NS = S::NS, SC = S::SC2, OC = DC / 8;
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* ks = reinterpret_cast<bf16*>(smraw);  // [BJ] rows: the block's keys
  bf16* vs = ks + BJ * HDM;                   // [BJ] rows: their values
  bf16* qs = vs + BJ * HDM;                   // [NS][BI] rows: query tiles
  bf16* os = qs + NS * BI * HDM;              // [NS][BI] rows: their dout rows
  float* sts = reinterpret_cast<float*>(os + NS * BI * HDM);  // [NS][3][BI] their statistics
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int heads = D / hd;
  const int per = (Tn + BJ - 1) / BJ * nch;  // blocks of one (sequence, head)
  const int g64 = (warp >> 2) * 64 * HDM;    // the warpgroup's 64 rows of ks, vs

  // blocks in (sequence, head, key tile, column chunk) order, the last
  // fastest: the tiles of one (sequence, head) share its queries, dout rows
  // and statistics through L2
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int z = static_cast<int>(b % per);
    const long long sh = b / per;
    const long long base = (sh / heads) * Tn * D + (sh % heads) * hd;
    const long long sbase = sh * Tn;
    const int k0 = (z / nch) * BJ, c0 = (z % nch) * DC;
    const int jw0 = k0 + warp * 16;         // the warp's first key
    const bool live = jw0 < Tn;
    const int j_lo = jw0 + (lane >> 2);  // the lane's keys: j_lo and j_lo + 8
    const int i_first = causal ? k0 : 0;
    const int ntiles = (Tn - i_first + BI - 1) / BI;
    auto load_q = [&](int stage, int i0) {
      mt::load_tile<HDM>(qs + stage * BI * HDM, q, base, i0, BI, Tn, hd, D, vec);
      mt::load_tile<HDM>(os + stage * BI * HDM, dout, base, i0, BI, Tn, hd, D, vec);
      float* st = sts + stage * 3 * BI;
      for (int e = threadIdx.x; e < 3 * BI; e += blockDim.x) {
        const int f = e / BI, i = i0 + e - f * BI;
        mt::cp_async4(st + e, a.stats + (sbase + min(i, Tn - 1)) * 3 + f, i < Tn ? 4 : 0);
      }
    };

    __syncthreads();
    mt::load_tile<HDM>(ks, k, base, k0, BJ, Tn, hd, D, vec);
    mt::load_tile<HDM>(vs, v, base, k0, BJ, Tn, hd, D, vec);
#pragma unroll
    for (int t = 0; t < NS - 1; ++t) {
      if (t < ntiles) load_q(t, i_first + t * BI);
      mt::cp_commit();
    }
    float dv[OC][4], dk[OC][4];
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[c][e] = dk[c][e] = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      const int i0 = i_first + t * BI;
      if (t + NS - 1 < ntiles) load_q((t + NS - 1) % NS, i0 + (NS - 1) * BI);
      mt::cp_commit();
      mt::cp_wait<NS - 1>();
      __syncthreads();
      const bf16* qt = qs + (t % NS) * BI * HDM;
      const bf16* ot = os + (t % NS) * BI * HDM;
      const float* st = sts + (t % NS) * 3 * BI;
      float s[SC][4], dp[SC][4];
      two_dots<HDM, SC>(s, dp, ks + g64, qt, vs + g64, ot);
      // the mask: query column cc (past the quad's first) of key row j is
      // kept when j - i0 - qc <= cc (causal) and cc <= Tn - 1 - i0 - qc
      const int qc = (lane & 3) * 2, last = Tn - 1 - i0 - qc;
      const int first_lo = causal ? j_lo - i0 - qc : -BI, first_hi = first_lo + 8;
      const bool full = (!causal || i0 >= jw0 + 15) && i0 + BI <= Tn;
      auto elems = [&](auto masked) {
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          mt::rc2(s[c][0], s[c][2]);
          mt::rc2(s[c][1], s[c][3]);
          mt::rc2(dp[c][0], dp[c][2]);
          mt::rc2(dp[c][1], dp[c][3]);
#pragma unroll
          for (int b = 0; b < 2; ++b) {  // the thread's two queries of the chunk
            const int cc = c * 8 + b, ci = cc + qc;
            const float mx = st[ci], sm = st[BI + ci], sg = st[2 * BI + ci];
            const float rs = mt::rcp(sm);
            float p[2], w[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // keys j_lo, j_lo + 8
              const float ex = expf(__fsub_rn(__fmul_rn(s[c][b + 2 * h], scale), mx));
              p[h] = mt::div(ex, sm, rs);
              w[h] = __fmul_rn(__fmul_rn(__fadd_rn(mt::div(dp[c][b + 2 * h], sm, rs), -sg), ex),
                               scale);
            }
            mt::rc2(p[0], p[1]);
            mt::rc2(w[0], w[1]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool keep =
                  !decltype(masked)::value || ((h ? first_hi : first_lo) <= cc && cc <= last);
              s[c][b + 2 * h] = keep ? p[h] : 0.0f;
              dp[c][b + 2 * h] = keep ? w[h] : 0.0f;
            }
          }
        }
      };
      if (full)
        elems(std::false_type{});
      else
        elems(std::true_type{});
      mt::mul_acc<HDM, OC, BI / 16>(dv, s, ot, c0);
      mt::mul_acc<HDM, OC, BI / 16>(dk, dp, qt, c0);
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j_lo + (e >> 1) * 8;
          const int d = c0 + c * 8 + (lane & 3) * 2 + (e & 1);
          if (j < Tn && d < hd) {
            const long long g = base + static_cast<long long>(j) * D + d;
            static_cast<bf16*>(a.dv)[g] = __float2bfloat16_rn(dv[c][e]);
            static_cast<bf16*>(a.dk)[g] = __float2bfloat16_rn(dk[c][e]);
          }
        }
    }
  }
}

template <int HDM>
int launch_tc_bwd(Args a, int N, int heads, cudaStream_t stream) {
  using S = TcTiles<HDM>;
  const size_t s1 = tc_dq_smem_bytes<HDM>(), s2 = tc_dkv_smem_bytes<HDM>();
  cudaError_t err = cudaFuncSetAttribute(attention_tiled_dq_tc<HDM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_tiled_dkv_tc<HDM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.hd)));
  a.tiles = (a.Tn + S::BQ - 1) / S::BQ;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const int vec = a.hd % 8 == 0 && (addr & 15) == 0;
  const int nch = (a.hd + S::DC - 1) / S::DC;
  const long long t1 = static_cast<long long>(N) * heads * a.tiles;
  const long long t2 = static_cast<long long>(N) * heads * ((a.Tn + S::BJ - 1) / S::BJ * nch);
  attention_tiled_dq_tc<HDM><<<static_cast<unsigned>(t1 < mt::kMaxGrid ? t1 : mt::kMaxGrid),
                               S::WG * 128, s1, stream>>>(a, t1, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_tiled_dkv_tc<HDM><<<static_cast<unsigned>(t2 < mt::kMaxGrid ? t2 : mt::kMaxGrid),
                                S::WG * 128, s2, stream>>>(a, t2, vec, nch);
  return static_cast<int>(cudaGetLastError());
}

int by_head_dim_tc(const Args& a, int N, int heads, cudaStream_t st) {
  if (a.hd <= 32) return launch_tc_bwd<32>(a, N, heads, st);
  if (a.hd <= 64) return launch_tc_bwd<64>(a, N, heads, st);
  if (a.hd <= 128) return launch_tc_bwd<128>(a, N, heads, st);
  return launch_tc_bwd<256>(a, N, heads, st);
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
  return kind == KIND_BF16 ? by_head_dim_tc(a, N, heads, st) : by_head_dim<float>(a, N, heads, st);
}
