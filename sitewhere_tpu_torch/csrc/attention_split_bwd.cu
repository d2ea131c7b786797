// KA's backward, split form: the backward of attention_split.cu at head
// dims past 256 (any hd), any sequence length. Heads are split by column of
// [N, T, heads * hd] rows.
//
// Replaces the vjp of sitewhere_tpu/models/common.py:61 attn_core under
// jax.grad (the transformer's loss_stacked) where the tiled backward
// (attention_tiled_bwd.cu, hd 1..256) does not take the head dim. The
// rounding points are attention_tiled_bwd.cu's: dp = dout . v^T
// accumulated in f32 over the full head dim and rounded; the Sigma term a
// = sum_k (dp_k * (1 / s^2)) * e_k; dl = ((dp / s) - a) * e times
// 1/sqrt(hd), rounded (e = exp(l - max), s = sum e, masked keys 0); dq =
// dl . k, dk = dl^T . q and dv = p^T . dout, each accumulated in f32 and
// rounded once, p = rc(e / s) as the forward rounds it.
//
// Design, the tiled backward's two kernels with the forward's column split
// (attention_split.cuh), no atomics (two runs are bitwise equal), p never
// stored:
//   1. dQ, one block per (sequence, head, column chunk, query tile of 8):
//      pass 1 the rows' max and sum, pass 2 the Sigma term, pass 3 dl and
//      dq for the block's own columns (the key tile's own columns staged
//      after the logits and dp, which stream the full head dim); the
//      chunk-0 block writes the rows' (max, sum, a) to f32[N, heads, T, 3].
//      Every chunk's block computes the same statistics.
//   2. dK and dV, one block per (sequence, head, column chunk, key tile of
//      8), a lane a query of each streamed 32-query tile: the logits and dp
//      over the full head dim, p and dl from the statistics, then the query
//      tile's q and dout rows of the block's own columns staged and dk, dv
//      accumulated. A causal key tile starts at its first key's query.
//
// Bound on the H100: at the transformer's dim 512, one head (65,536 x 31
// x 512, bf16, causal) it reads q, k, v, dout and writes dq, dk, dv, 14.6
// GB (4.3 ms at 3.35 TB/s), and does 8 hd FLOP a (query, key) pair of the
// causal triangle (0.13 ms at the bf16 tensor rate): bytes. This form
// recomputes the logits and dp in both kernels and in every chunk's block,
// on CUDA cores; tensor-core tiles are the open speed work.
#include <cmath>

#include "attention_split.cuh"

namespace {

using namespace ka_split;

size_t dq_smem_bytes() {
  return (2 * static_cast<size_t>(kTile) * kRS + 2 * static_cast<size_t>(kBR) * kChunk +
          static_cast<size_t>(kWarps) * kRW * kTile) *
         sizeof(float);
}

size_t dkv_smem_bytes() {
  return (2 * static_cast<size_t>(kBR) * kChunk + 2 * static_cast<size_t>(kTile) * kRS +
          2 * static_cast<size_t>(kWarps) * kRW * kTile) *
         sizeof(float);
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv; float* stats;
  int Tn; int D; int hd; int heads; int chunks; int causal; float scale; int tiles;
};

// kernel 1: dq and the rows' statistics
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) attention_split_dq(const Args a) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                   // [kTile][kRS] a key chunk (then own columns)
  float* vs = ks + kTile * kRS;     // [kTile][kRS] a value chunk
  float* qs = vs + kTile * kRS;     // [kBR][kChunk] a query chunk
  float* os = qs + kBR * kChunk;    // [kBR][kChunk] its dout chunk
  float* dls = os + kBR * kChunk;   // [kWarps][kRW][kTile]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const float scale = a.scale;
  const int head = blockIdx.y / a.chunks;
  const int chunk = blockIdx.y - head * a.chunks;
  const int own = chunk * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(head) * hd;
  const long long sbase = (static_cast<long long>(blockIdx.x) * a.heads + head) * Tn;
  float* dw = dls + warp * kRW * kTile;
  const float* qw = qs + warp * kRW * kChunk;
  const float* ow = os + warp * kRW * kChunk;
  const float ninf = -__int_as_float(0x7f800000);

  for (int qt = blockIdx.z; qt < a.tiles; qt += gridDim.z) {
    const int q0 = qt * kBR;
    const int i0 = q0 + warp * kRW;
    const int nk = causal ? min(q0 + kBR, Tn) : Tn;
    // the raw logits (and with want_dp the raw dp) of the warp's rows with
    // key j0 + lane, over the full head dim
    auto dots = [&](int j0, bool want_dp, float (&l)[kRW], float (&dp)[kRW]) {
#pragma unroll
      for (int r = 0; r < kRW; ++r) l[r] = dp[r] = 0.0f;
      for (int c0 = 0; c0 < hd; c0 += kChunk) {
        __syncthreads();
        stage_cols(qs, q, base, q0, kBR, Tn, true, c0, hd, kChunk, D);
        stage_cols(ks, k, base, j0, kTile, nk, false, c0, hd, kRS, D);
        if (want_dp) {
          stage_cols(os, dout, base, q0, kBR, Tn, true, c0, hd, kChunk, D);
          stage_cols(vs, v, base, j0, kTile, nk, false, c0, hd, kRS, D);
        }
        __syncthreads();
        const int w4 = chunk_w4(c0, hd);
        dots_acc(qw, kChunk, ks + lane * kRS, w4, l);
        if (want_dp) dots_acc(ow, kChunk, vs + lane * kRS, w4, dp);
      }
    };
    float mx[kRW], sum[kRW], sg[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      mx[r] = ninf;
      sum[r] = 0.0f;
      sg[r] = 0.0f;
    }
    // pass 1: max and sum
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW], dp[kRW];
      dots(j0, false, l, dp);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = ok ? __fmul_rn(rc<T>(l[r]), scale) : ninf;
        const float nm = fmaxf(mx[r], warp_max(lr));
        const float e = ok ? expf(__fsub_rn(lr, nm)) : 0.0f;
        sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), warp_sum(e));
        mx[r] = nm;
      }
    }
    float is2[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) is2[r] = __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r]));
    // pass 2: the Sigma term, each lane over its keys, then the warp's sum
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW], dp[kRW];
      dots(j0, true, l, dp);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        if (j < nk && (!causal || j <= i)) {
          const float e = expf(__fsub_rn(__fmul_rn(rc<T>(l[r]), scale), mx[r]));
          sg[r] = __fadd_rn(sg[r], __fmul_rn(__fmul_rn(rc<T>(dp[r]), is2[r]), e));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) sg[r] = warp_sum(sg[r]);
    // pass 3: dl, then dq over the block's own columns
    float acc[kRW][kHQ];
#pragma unroll
    for (int r = 0; r < kRW; ++r)
#pragma unroll
      for (int c = 0; c < kHQ; ++c) acc[r][c] = 0.0f;
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW], dp[kRW];
      dots(j0, true, l, dp);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        float w = 0.0f;
        if (j < nk && (!causal || j <= i)) {
          const float e = expf(__fsub_rn(__fmul_rn(rc<T>(l[r]), scale), mx[r]));
          const float dl = __fmul_rn(__fadd_rn(__fdiv_rn(rc<T>(dp[r]), sum[r]), -sg[r]), e);
          w = rc<T>(__fmul_rn(dl, scale));
        }
        dw[r * kTile + lane] = w;
      }
      __syncthreads();  // every warp is past its reads of ks
      stage_cols(ks, k, base, j0, kTile, nk, false, own, hd, kRS, D);
      __syncthreads();
      const int kn = min(kTile, nk - j0);
      for (int jj = 0; jj < kn; ++jj) {
        float kv[kHQ];
#pragma unroll
        for (int c = 0; c < kHQ; ++c) kv[c] = ks[jj * kRS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float w = dw[r * kTile + jj];
#pragma unroll
          for (int c = 0; c < kHQ; ++c) acc[r][c] = fmaf(w, kv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int i = i0 + r;
      if (i >= Tn) continue;
      const long long row = base + static_cast<long long>(i) * D;
#pragma unroll
      for (int c = 0; c < kHQ; ++c) {
        const int d = own + lane + 32 * c;
        if (d < hd) put(static_cast<T*>(a.dq) + row + d, acc[r][c]);
      }
      if (chunk == 0 && lane == 0) {
        float* st = a.stats + (sbase + i) * 3;
        st[0] = mx[r];
        st[1] = sum[r];
        st[2] = sg[r];
      }
    }
  }
}

// kernel 2: dk and dv
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) attention_split_dkv(const Args a) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                   // [kBR][kChunk] a chunk of the block's keys
  float* vs = ks + kBR * kChunk;    // [kBR][kChunk] of their values
  float* qs = vs + kBR * kChunk;    // [kTile][kRS] a query tile's chunk (then own columns)
  float* os = qs + kTile * kRS;     // [kTile][kRS] of its dout rows
  float* pb = os + kTile * kRS;     // [kWarps][kRW][kTile] p
  float* lb = pb + kWarps * kRW * kTile;  // [kWarps][kRW][kTile] dl (rounded)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const float scale = a.scale;
  const int head = blockIdx.y / a.chunks;
  const int own = (blockIdx.y - head * a.chunks) * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(head) * hd;
  const long long sbase = (static_cast<long long>(blockIdx.x) * a.heads + head) * Tn;
  float* pw = pb + warp * kRW * kTile;
  float* lw = lb + warp * kRW * kTile;
  const float* kw = ks + warp * kRW * kChunk;
  const float* vw = vs + warp * kRW * kChunk;

  for (int kt = blockIdx.z; kt < a.tiles; kt += gridDim.z) {
    const int k0 = kt * kBR;
    const int j0 = k0 + warp * kRW;  // the warp's first key
    float av[kRW][kHQ], ak[kRW][kHQ];
#pragma unroll
    for (int r = 0; r < kRW; ++r)
#pragma unroll
      for (int c = 0; c < kHQ; ++c) av[r][c] = ak[r][c] = 0.0f;
    for (int i0 = causal ? k0 : 0; i0 < Tn; i0 += kTile) {
      // the logits and dp of query i0 + lane with the warp's keys, over the
      // full head dim (keys past T repeat the last; never stored)
      float l[kRW], dp[kRW];
#pragma unroll
      for (int r = 0; r < kRW; ++r) l[r] = dp[r] = 0.0f;
      for (int c0 = 0; c0 < hd; c0 += kChunk) {
        __syncthreads();
        stage_cols(ks, k, base, k0, kBR, Tn, true, c0, hd, kChunk, D);
        stage_cols(vs, v, base, k0, kBR, Tn, true, c0, hd, kChunk, D);
        stage_cols(qs, q, base, i0, kTile, Tn, false, c0, hd, kRS, D);
        stage_cols(os, dout, base, i0, kTile, Tn, false, c0, hd, kRS, D);
        __syncthreads();
        const int w4 = chunk_w4(c0, hd);
        dots_acc(kw, kChunk, qs + lane * kRS, w4, l);
        dots_acc(vw, kChunk, os + lane * kRS, w4, dp);
      }
      const int i = i0 + lane;
      float mx = 0.0f, sum = 1.0f, sg = 0.0f;
      if (i < Tn) {
        const float* st = a.stats + (sbase + i) * 3;
        mx = st[0];
        sum = st[1];
        sg = st[2];
      }
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
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
      __syncthreads();  // every warp is past its reads of qs and os
      stage_cols(qs, q, base, i0, kTile, Tn, false, own, hd, kRS, D);
      stage_cols(os, dout, base, i0, kTile, Tn, false, own, hd, kRS, D);
      __syncthreads();
      const int qn = min(kTile, Tn - i0);
      for (int ii = 0; ii < qn; ++ii) {
        float ov[kHQ], qv[kHQ];
#pragma unroll
        for (int c = 0; c < kHQ; ++c) {
          ov[c] = os[ii * kRS + lane + 32 * c];
          qv[c] = qs[ii * kRS + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float p = pw[r * kTile + ii], w = lw[r * kTile + ii];
#pragma unroll
          for (int c = 0; c < kHQ; ++c) {
            av[r][c] = fmaf(p, ov[c], av[r][c]);
            ak[r][c] = fmaf(w, qv[c], ak[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int j = j0 + r;
      if (j >= Tn) continue;
      const long long row = base + static_cast<long long>(j) * D;
#pragma unroll
      for (int c = 0; c < kHQ; ++c) {
        const int d = own + lane + 32 * c;
        if (d < hd) {
          put(static_cast<T*>(a.dv) + row + d, av[r][c]);
          put(static_cast<T*>(a.dk) + row + d, ak[r][c]);
        }
      }
    }
  }
}

template <typename T>
int launch_split_bwd(Args a, int N, cudaStream_t stream) {
  const size_t s1 = dq_smem_bytes(), s2 = dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(attention_split_dq<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_split_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.hd)));
  a.chunks = (a.hd + kChunk - 1) / kChunk;
  a.tiles = (a.Tn + kBR - 1) / kBR;
  const dim3 grid(N, a.heads * a.chunks, a.tiles < 65535 ? a.tiles : 65535);
  attention_split_dq<T><<<grid, kWarps * 32, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_split_dkv<T><<<grid, kWarps * 32, s2, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [N, T, heads * hd] in the compute dtype (kind
// KIND_F32 or KIND_BF16); stats: f32[N, heads, T, 3] scratch; any hd >= 1
// (the route sends hd > 256 here); any T >= 1. Launches kernel 1 (dq), then
// kernel 2 (dk, dv).
extern "C" int sw_attention_split_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      float* stats, int N, int T, int heads, int hd, int causal,
                                      int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || T < 1 || heads < 1 || hd < 1 ||
      static_cast<long long>(heads) * ((hd + kChunk - 1) / kChunk) > 65535 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, dout, dq, dk, dv, stats, T, heads * hd, hd, heads, 0, causal, 0.0f, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? launch_split_bwd<__nv_bfloat16>(a, N, st)
                           : launch_split_bwd<float>(a, N, st);
}
