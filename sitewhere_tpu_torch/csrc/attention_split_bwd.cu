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
// Design, bf16 (attention_split_bwd_tc, attention_split_dq_tc,
// attention_split_dkv_tc; attention_split.cuh ka_split_tc): tensor cores,
// a block one warpgroup and one 64-row tile, every product a compile-time
// m64n64k16 wgmma over a chunk of the head dim streamed through a ring
// (cp.async as the forward's loader), p and dl rounded into bf16 tiles in
// shared memory as the A operand of the gradient products, each output
// chunk stored once; no atomics (two runs are bitwise equal).
//   T <= 64 (attention_split_bwd_tc): one kernel, a block per tile of 64
//      rows (items packed as the forward packs them). The logits and dp
//      over the head dim's 32-column chunks, the exact softmax, the Sigma
//      term and dl in registers; p^T, dl^T and dl into shared memory; then
//      per 64 output columns dq = dl . k, dk = dl^T . q, dv = p^T . dout.
//      Every input read once for the logits and dp, and k, q, dout once
//      more for the products (the last columns first, while L2 still holds
//      them); no statistics leave the block.
//   T > 64: the tiled backward's two kernels with full-hd tiles in column
//      chunks.
//      attention_split_dq_tc, a block per (item, query tile): pass 1 the
//      rows' max and sum (online), pass 2 the Sigma term, pass 3 dl into a
//      cache of the tile's dl rows, then dq += dl . k per 64 columns; the
//      rows' (max, sum, a) to f32[N, heads, T, 3]. attention_split_dkv_tc,
//      a block per (item, key tile), its keys the rows of k . q^T and v .
//      dout^T over each query tile (from the key tile's first query when
//      causal), so p^T and dl^T come out with the keys as rows, from the
//      statistics into caches, then dk += dl^T . q and dv += p^T . dout
//      per 64 columns. Caches past what fits (dq T > 1,280, dk/dv T > 640)
//      hold one tile, recomputed before each product.
//
// f32 (attention_split_dq, attention_split_dkv; ka_split): CUDA cores, the
// tiled backward's two kernels with the forward's f32 column split, p
// never stored:
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
// GB (4.35 ms at 3.35 TB/s), and does 8 hd FLOP a (query, key) pair of the
// causal triangle (0.13 ms at the bf16 tensor rate): bytes. The bf16 form
// there: 11.01 ms on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py
// split_attention_phase), 2.53x the bound (the CUDA-core form: 655.8
// ms); its second loop reads k, q and dout again (20.8 GB moved in all).
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

// ---- the bf16 instance: tensor cores ----------------------------------------

namespace tc = ka_split_tc;
using tc::bf16;

constexpr int kNS = 2;                 // ring stages
constexpr int kStage = 4 * tc::kTile;  // a stage: up to four 64 x 64 chunks
enum { kStat = 0, kSig = 1, kFill = 2, kOut = 3 };

struct TcArgs {
  const bf16* q; const bf16* k; const bf16* v; const bf16* dout;
  bf16* dq; bf16* dk; bf16* dv; float* stats;
  int T; int D; int hd; int heads; int causal; float scale;
  long long items; long long blocks;
  int lg; int tiles; int nch; int vw; int pairs; int res;
};

// the softmax's backward of one key column for one row, the reference's
// rounding points: p = rc(e / s) and dl = rc(((dp / s) - a) e / sqrt(hd))
// (dp rounded by the caller), both 0 where the key is dropped
__device__ __forceinline__ void p_dl(float l, float dp, float mx, float sum, float rs, float sg,
                                     float scale, bool kept, float& p, float& w) {
  const float e = expf(__fsub_rn(l, mx));
  p = kept ? mt::div(e, sum, rs) : 0.0f;
  w = kept ? __fmul_rn(__fmul_rn(__fadd_rn(mt::div(dp, sum, rs), -sg), e), scale) : 0.0f;
}

// One kernel where a tile holds every key (T <= 64; 2..8 items a tile at T
// <= 32): a block per tile, one warpgroup, two loops over one ring of kNS1
// stages. The first forms the logits and dp over the head dim's 32-column
// chunks (q, k, dout, v); then the exact softmax, p, the Sigma term and dl
// in registers, and p^T, dl^T and dl into shared memory as bf16 tiles; the
// second, 64 output columns a step (k, q, dout), dq = dl . k, dk = dl^T . q
// and dv = p^T . dout, each stored once. No statistics leave the block. The
// narrow first chunks keep a stage at 24 KB, so three blocks share an SM
// (registers capped at 168).
constexpr int kNS1 = 2;
constexpr int kDC1 = 32;                                   // the first loop's chunk columns
constexpr int kStage1 = 3 * tc::kTile;                     // 4 chunks of 64 x 32, or 3 of 64 x 64
__global__ void __launch_bounds__(tc::kThreads, 3) attention_split_bwd_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[tc::kMaxItems];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  bf16* pt = ring + kNS1 * kStage1;  // p^T (rows keys)
  bf16* lt = pt + tc::kTile;         // dl^T
  bf16* ln = lt + tc::kTile;         // dl (rows queries)
  const int T = a.T, D = a.D, hd = a.hd, causal = a.causal, lg = a.lg, nch = a.nch, vw = a.vw;
  const int msk = (1 << lg) - 1, G = tc::kRows >> lg;
  const int n1 = (hd + kDC1 - 1) / kDC1, nsteps = n1 + nch;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float ninf = -__int_as_float(0x7f800000);
  constexpr int kC = tc::kRows * kDC1;  // elements of a 64 x 32 chunk

  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    const long long it0 = b * G;
    const tc::Rows rw{ib, static_cast<int>(min(static_cast<long long>(G), a.items - it0)), lg};
    // step st < n1: q, k, dout, v columns [32 st, + 32); past it k, q, dout
    // columns [64 (nsteps - 1 - st), + 64): the last columns first, the ones
    // the first loop read last, while L2 still holds them
    auto load = [&](int st) {
      bf16* dst = ring + (st % kNS1) * kStage1;
      if (st < n1) {
        const int c0 = st * kDC1;
        tc::load_tile<kDC1>(dst, a.q, rw, 0, T, D, hd, c0, vw);
        tc::load_tile<kDC1>(dst + kC, a.k, rw, 0, T, D, hd, c0, vw);
        tc::load_tile<kDC1>(dst + 2 * kC, a.dout, rw, 0, T, D, hd, c0, vw);
        tc::load_tile<kDC1>(dst + 3 * kC, a.v, rw, 0, T, D, hd, c0, vw);
      } else {
        const int c0 = (nsteps - 1 - st) * tc::kDC;
        tc::load_tile<tc::kDC>(dst, a.k, rw, 0, T, D, hd, c0, vw);
        tc::load_tile<tc::kDC>(dst + tc::kTile, a.q, rw, 0, T, D, hd, c0, vw);
        tc::load_tile<tc::kDC>(dst + 2 * tc::kTile, a.dout, rw, 0, T, D, hd, c0, vw);
      }
    };
    auto next = [&](int st) {  // the ring's turn before step st's products
      if (st + kNS1 - 1 < nsteps) load(st + kNS1 - 1);
      mt::cp_commit();
      mt::cp_wait<kNS1 - 1>();
      __syncthreads();
    };

    __syncthreads();
    if (threadIdx.x < G)
      ib[threadIdx.x] = tc::item_base(it0 + threadIdx.x, T, D, hd, a.heads);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kNS1 - 1; ++st) {
      load(st);
      mt::cp_commit();
    }
    float s[8][4], dp[8][4];
    for (int st = 0; st < n1; ++st) {
      next(st);
      const bf16* stg = ring + (st % kNS1) * kStage1;
      tc::chunk_dots2<kDC1>(s, dp, stg, stg + kC, stg + 2 * kC, stg + 3 * kC, st);
      __syncthreads();
    }
    // the exact softmax of each row, then p, the Sigma term and dl
    tc::scale_mask(s, r_lo, qc, scale, [&](int r, int col) {
      return (r >> lg) == (col >> lg) && (col & msk) < T && (!causal || (col & msk) <= (r & msk));
    });
    float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f};
    tc::row_stats(s, mx, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      const float is2 = __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r])), rs = mt::rcp(sum[r]);
      float sg = 0.0f;  // a dropped key adds (dp / s^2) exp(-inf) = 0
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        mt::rc2(dp[c8][2 * r], dp[c8][2 * r + 1]);
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          sg = __fadd_rn(sg, __fmul_rn(__fmul_rn(dp[c8][e], is2), expf(__fsub_rn(s[c8][e], mx[r]))));
      }
      sg = mt::quad_sum(sg);
      // a padding row (past T or past the items) adds nothing to dk, dv
      const bool ok = (row >> lg) < rw.ng && (row & msk) < T;
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        float p[2], w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          p_dl(s[c8][2 * r + h], dp[c8][2 * r + h], mx[r], sum[r], rs, sg, scale,
               ok && s[c8][2 * r + h] != ninf, p[h], w[h]);
        mt::rc2(p[0], p[1]);
        mt::rc2(w[0], w[1]);
        const int col = 8 * c8 + qc;
        tc::put2(ln, row, col, w[0], w[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pt[mt::tile_at<tc::kDC>(col + h, row)] = __float2bfloat16_rn(p[h]);
          lt[mt::tile_at<tc::kDC>(col + h, row)] = __float2bfloat16_rn(w[h]);
        }
      }
    }
    mt::fence_async();
    for (int st = n1; st < nsteps; ++st) {
      next(st);
      // output columns [c0, c0 + 64): dq = dl . k, dk = dl^T . q, dv =
      // p^T . dout
      const bf16* stg = ring + (st % kNS1) * kStage1;
      const int c0 = (nsteps - 1 - st) * tc::kDC;
      float gq[8][4], gk[8][4], gv[8][4];
      mt::wg_fence();
      tc::tile_mul<tc::kDC>(gq, ln, stg, 0, 0);
      tc::tile_mul<tc::kDC>(gk, lt, stg + tc::kTile, 0, 0);
      tc::tile_mul<tc::kDC>(gv, pt, stg + 2 * tc::kTile, 0, 0);
      mt::wg_commit();
      mt::wg_wait();
      mt::pin(gq);
      mt::pin(gk);
      mt::pin(gv);
      tc::store_rows<8>(a.dq, gq, rw, 0, r_lo, qc, c0, T, D, hd, a.pairs);
      tc::store_rows<8>(a.dk, gk, rw, 0, r_lo, qc, c0, T, D, hd, a.pairs);
      tc::store_rows<8>(a.dv, gv, rw, 0, r_lo, qc, c0, T, D, hd, a.pairs);
      __syncthreads();
    }
  }
}

// Past one key tile, kernel 1: dq and each row's (max, sum, Sigma term) to
// the stats buffer. A block per (item, query tile of 64); its steps through
// the ring: pass 1 max and sum (online) from the logits of every key tile,
// pass 2 the Sigma term from the logits and dp, pass 3 dl = rc(((dp / s) -
// a) e / sqrt(hd)) into the dl cache (every key tile while it fits; else
// recomputed before each product, one cache tile), then for each 64 output
// columns dq += dl . k over the key tiles, stored once.
__global__ void __launch_bounds__(tc::kThreads) attention_split_dq_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[1];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  bf16* dc = ring + kNS * kStage;  // dl tiles: [key tile, or 1][64 x 64]
  const int T = a.T, D = a.D, hd = a.hd, causal = a.causal, nch = a.nch, vw = a.vw;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float ninf = -__int_as_float(0x7f800000);

  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    const long long it = b / a.tiles;
    const int q0 = static_cast<int>(b % a.tiles) * tc::kRows;
    const tc::Rows rw{ib, 1, 6};
    const int nk = causal ? min(q0 + tc::kRows, T) : T;
    const int ntk = (nk + tc::kRows - 1) / tc::kRows;
    const int n1 = ntk * nch, n3 = a.res ? n1 : 0, per = a.res ? 1 : nch + 1;
    const int nsteps = 2 * n1 + n3 + nch * ntk * per;
    auto at = [&](int st, int& kind, int& j, int& c) {
      if (st < 2 * n1 + n3) {
        kind = st / n1;  // kStat, kSig, kFill
        st -= kind * n1;
        j = st / nch;
        c = st - j * nch;
        return;
      }
      st -= 2 * n1 + n3;
      const int cc = st / (ntk * per);
      st -= cc * ntk * per;
      j = st / per;
      const int w = st - j * per;
      kind = w < per - 1 ? kFill : kOut;
      c = w < per - 1 ? w : cc;
    };
    auto load = [&](int st) {
      int kind, j, c;
      at(st, kind, j, c);
      bf16* dst = ring + (st % kNS) * kStage;
      const int j0 = j * tc::kRows, c0 = c * tc::kDC;
      if (kind == kOut) {
        tc::load_tile<tc::kDC>(dst, a.k, rw, j0, T, D, hd, c0, vw);
        return;
      }
      tc::load_tile<tc::kDC>(dst, a.q, rw, q0, T, D, hd, c0, vw);
      tc::load_tile<tc::kDC>(dst + tc::kTile, a.k, rw, j0, T, D, hd, c0, vw);
      if (kind != kStat) {
        tc::load_tile<tc::kDC>(dst + 2 * tc::kTile, a.dout, rw, q0, T, D, hd, c0, vw);
        tc::load_tile<tc::kDC>(dst + 3 * tc::kTile, a.v, rw, j0, T, D, hd, c0, vw);
      }
    };

    __syncthreads();
    if (threadIdx.x == 0) ib[0] = tc::item_base(it, T, D, hd, a.heads);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kNS - 1; ++st) {
      load(st);
      mt::cp_commit();
    }
    float s[8][4], dp[8][4], acc[8][4];
    float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f}, is2[2], rs[2];
    tc::zero(acc);
    for (int st = 0; st < nsteps; ++st) {
      if (st + kNS - 1 < nsteps) load(st + kNS - 1);
      mt::cp_commit();
      mt::cp_wait<kNS - 1>();
      __syncthreads();
      int kind, j, c;
      at(st, kind, j, c);
      const bf16* stg = ring + (st % kNS) * kStage;
      bf16* dl = dc + (a.res ? j : 0) * tc::kTile;
      if (kind == kOut) {
        mt::wg_fence();
        tc::tile_mul<tc::kDC>(acc, dl, stg, 0, 1);
        mt::wg_commit();
        mt::wg_wait();
        mt::pin(acc);
        if (j == ntk - 1) {
          tc::store_rows<8>(a.dq, acc, rw, q0, r_lo, qc, c * tc::kDC, T, D, hd, a.pairs);
          tc::zero(acc);
        }
      } else {
        if (kind == kStat)
          tc::chunk_dots(s, stg, stg + tc::kTile, c);
        else
          tc::chunk_dots2(s, dp, stg, stg + tc::kTile, stg + 2 * tc::kTile, stg + 3 * tc::kTile,
                          c);
        if (c == nch - 1) {
          tc::scale_mask(s, r_lo, qc, scale, [&](int r, int col) {
            const int kp = j * tc::kRows + col;
            return kp < T && (!causal || kp <= q0 + r);
          });
          if (kind == kStat) {
            tc::row_stats(s, mx, sum);
            if (j == ntk - 1) {
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                is2[r] = __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r]));
                rs[r] = mt::rcp(sum[r]);
              }
            }
          } else {
#pragma unroll
            for (int c8 = 0; c8 < 8; ++c8) {
              mt::rc2(dp[c8][0], dp[c8][1]);
              mt::rc2(dp[c8][2], dp[c8][3]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (kind == kSig) {
#pragma unroll
                for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
                  for (int e = 2 * r; e < 2 * r + 2; ++e)
                    sg[r] = __fadd_rn(sg[r], __fmul_rn(__fmul_rn(dp[c8][e], is2[r]),
                                                       expf(__fsub_rn(s[c8][e], mx[r]))));
                if (j == ntk - 1) sg[r] = mt::quad_sum(sg[r]);
              } else {
#pragma unroll
                for (int c8 = 0; c8 < 8; ++c8) {
                  float p[2], w[2];
#pragma unroll
                  for (int h = 0; h < 2; ++h)
                    p_dl(s[c8][2 * r + h], dp[c8][2 * r + h], mx[r], sum[r], rs[r], sg[r],
                         scale, s[c8][2 * r + h] != ninf, p[h], w[h]);
                  mt::rc2(w[0], w[1]);
                  tc::put2(dl, r_lo + 8 * r, 8 * c8 + qc, w[0], w[1]);
                }
              }
            }
          }
          if (kind == kFill) mt::fence_async();
        }
      }
      __syncthreads();
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + r_lo + 8 * r;
        if (i < T) {
          float* st = a.stats + (it * T + i) * 3;
          st[0] = mx[r];
          st[1] = sum[r];
          st[2] = sg[r];
        }
      }
    }
  }
}

// Past one key tile, kernel 2: dk and dv. A block per (item, key tile of
// 64), its keys the rows of k . q^T and v . dout^T over each query tile
// (from the key tile's first query when causal), so p^T and dl^T come out
// with the keys as rows: from the rows' statistics (kernel 1) into the p^T
// and dl^T caches (every query tile while they fit; else recomputed before
// each product), then for each 64 output columns dk += dl^T . q and dv +=
// p^T . dout over the query tiles, stored once.
__global__ void __launch_bounds__(tc::kThreads) attention_split_dkv_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[1];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  const int cached = a.res ? a.tiles : 1;
  bf16* pc = ring + kNS * kStage;     // p^T tiles: [query tile, or 1][64 x 64]
  bf16* lc = pc + cached * tc::kTile;  // dl^T tiles
  const int T = a.T, D = a.D, hd = a.hd, causal = a.causal, nch = a.nch, vw = a.vw;
  const float scale = a.scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;

  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    const long long it = b / a.tiles;
    const int k0 = static_cast<int>(b % a.tiles) * tc::kRows;
    const tc::Rows rw{ib, 1, 6};
    const int i_first = causal ? k0 : 0;
    const int ntq = (T - i_first + tc::kRows - 1) / tc::kRows;
    const int n1 = a.res ? ntq * nch : 0, per = a.res ? 1 : nch + 1;
    const int nsteps = n1 + nch * ntq * per;
    auto at = [&](int st, int& kind, int& i, int& c) {
      if (st < n1) {
        kind = kFill;
        i = st / nch;
        c = st - i * nch;
        return;
      }
      st -= n1;
      const int cc = st / (ntq * per);
      st -= cc * ntq * per;
      i = st / per;
      const int w = st - i * per;
      kind = w < per - 1 ? kFill : kOut;
      c = w < per - 1 ? w : cc;
    };
    auto load = [&](int st) {
      int kind, i, c;
      at(st, kind, i, c);
      bf16* dst = ring + (st % kNS) * kStage;
      const int i0 = i_first + i * tc::kRows, c0 = c * tc::kDC;
      if (kind == kOut) {
        tc::load_tile<tc::kDC>(dst, a.q, rw, i0, T, D, hd, c0, vw);
        tc::load_tile<tc::kDC>(dst + tc::kTile, a.dout, rw, i0, T, D, hd, c0, vw);
        return;
      }
      tc::load_tile<tc::kDC>(dst, a.k, rw, k0, T, D, hd, c0, vw);
      tc::load_tile<tc::kDC>(dst + tc::kTile, a.q, rw, i0, T, D, hd, c0, vw);
      tc::load_tile<tc::kDC>(dst + 2 * tc::kTile, a.v, rw, k0, T, D, hd, c0, vw);
      tc::load_tile<tc::kDC>(dst + 3 * tc::kTile, a.dout, rw, i0, T, D, hd, c0, vw);
    };

    __syncthreads();
    if (threadIdx.x == 0) ib[0] = tc::item_base(it, T, D, hd, a.heads);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kNS - 1; ++st) {
      load(st);
      mt::cp_commit();
    }
    float s[8][4], dp[8][4], gk[8][4], gv[8][4];
    tc::zero(gk);
    tc::zero(gv);
    for (int st = 0; st < nsteps; ++st) {
      if (st + kNS - 1 < nsteps) load(st + kNS - 1);
      mt::cp_commit();
      mt::cp_wait<kNS - 1>();
      __syncthreads();
      int kind, i, c;
      at(st, kind, i, c);
      const bf16* stg = ring + (st % kNS) * kStage;
      bf16* pt = pc + (a.res ? i : 0) * tc::kTile;
      bf16* lt = lc + (a.res ? i : 0) * tc::kTile;
      if (kind == kOut) {
        mt::wg_fence();
        tc::tile_mul<tc::kDC>(gk, lt, stg, 0, 1);
        tc::tile_mul<tc::kDC>(gv, pt, stg + tc::kTile, 0, 1);
        mt::wg_commit();
        mt::wg_wait();
        mt::pin(gk);
        mt::pin(gv);
        if (i == ntq - 1) {
          tc::store_rows<8>(a.dk, gk, rw, k0, r_lo, qc, c * tc::kDC, T, D, hd, a.pairs);
          tc::store_rows<8>(a.dv, gv, rw, k0, r_lo, qc, c * tc::kDC, T, D, hd, a.pairs);
          tc::zero(gk);
          tc::zero(gv);
        }
      } else {
        tc::chunk_dots2(s, dp, stg, stg + tc::kTile, stg + 2 * tc::kTile, stg + 3 * tc::kTile, c);
        if (c == nch - 1) {
          // column cc of the tile is query i0 + cc, with its row's
          // statistics; row r is key k0 + r
          const int i0 = i_first + i * tc::kRows;
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8) {
            mt::rc2(s[c8][0], s[c8][1]);
            mt::rc2(s[c8][2], s[c8][3]);
            mt::rc2(dp[c8][0], dp[c8][1]);
            mt::rc2(dp[c8][2], dp[c8][3]);
            float p[4], w[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // the thread's two queries of the chunk
              const int qi = i0 + 8 * c8 + qc + h;
              const float* st3 = a.stats + (it * T + min(qi, T - 1)) * 3;
              const float mx = st3[0], sm = st3[1], sg = st3[2], rs = mt::rcp(sm);
#pragma unroll
              for (int e = h; e < 4; e += 2) {  // keys r_lo, r_lo + 8
                const int kj = k0 + r_lo + 4 * (e & 2);
                p_dl(__fmul_rn(s[c8][e], scale), dp[c8][e], mx, sm, rs, sg, scale,
                     qi < T && kj < T && (!causal || kj <= qi), p[e], w[e]);
              }
            }
            mt::rc2(p[0], p[1]);
            mt::rc2(p[2], p[3]);
            mt::rc2(w[0], w[1]);
            mt::rc2(w[2], w[3]);
            tc::put2(pt, r_lo, 8 * c8 + qc, p[0], p[1]);
            tc::put2(pt, r_lo + 8, 8 * c8 + qc, p[2], p[3]);
            tc::put2(lt, r_lo, 8 * c8 + qc, w[0], w[1]);
            tc::put2(lt, r_lo + 8, 8 * c8 + qc, w[2], w[3]);
          }
          mt::fence_async();
        }
      }
      __syncthreads();
    }
  }
}

int launch_split_bwd_tc(const Args& g, int N, cudaStream_t stream) {
  const int T = g.Tn, hd = g.hd, heads = g.heads;
  const long long items = static_cast<long long>(N) * heads;
  const uintptr_t in = reinterpret_cast<uintptr_t>(g.q) | reinterpret_cast<uintptr_t>(g.k) |
                       reinterpret_cast<uintptr_t>(g.v) | reinterpret_cast<uintptr_t>(g.dout);
  const uintptr_t out = reinterpret_cast<uintptr_t>(g.dq) | reinterpret_cast<uintptr_t>(g.dk) |
                        reinterpret_cast<uintptr_t>(g.dv);
  const tc::Plan p = tc::plan(items, T, hd, in, out);
  TcArgs a{static_cast<const bf16*>(g.q), static_cast<const bf16*>(g.k),
           static_cast<const bf16*>(g.v), static_cast<const bf16*>(g.dout),
           static_cast<bf16*>(g.dq), static_cast<bf16*>(g.dk), static_cast<bf16*>(g.dv), g.stats,
           T, heads * hd, hd, heads, g.causal,
           static_cast<float>(1.0 / sqrt(static_cast<double>(hd))), items, p.blocks,
           p.lg, p.tiles, p.nch, p.vw, p.pairs, 1};
  const size_t ring = static_cast<size_t>(kNS) * kStage * sizeof(bf16);
  const unsigned grid = static_cast<unsigned>(p.blocks < mt::kMaxGrid ? p.blocks : mt::kMaxGrid);
  cudaError_t err;
  if (p.tiles == 1) {
    const size_t smem = (static_cast<size_t>(kNS1) * kStage1 + 3 * tc::kTile) * sizeof(bf16);
    err = cudaFuncSetAttribute(attention_split_bwd_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_split_bwd_tc<<<grid, tc::kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int c1 = tc::cache_tiles(ring, p.tiles, 1), c2 = tc::cache_tiles(ring, p.tiles, 2);
  const size_t s1 = ring + c1 * tc::kTileBytes, s2 = ring + 2 * c2 * tc::kTileBytes;
  err = cudaFuncSetAttribute(attention_split_dq_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_split_dkv_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.res = c1 == p.tiles;
  attention_split_dq_tc<<<grid, tc::kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.res = c2 == p.tiles;
  attention_split_dkv_tc<<<grid, tc::kThreads, s2, stream>>>(a);
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
  if (kind == KIND_BF16) return launch_split_bwd_tc(a, N, st);
  return launch_split_bwd<float>(a, N, st);
}
