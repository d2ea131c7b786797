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
// max, the sum and p (in f32 with the forward kernel's exact arithmetic:
// the same dot order, the same lane-strided sums and shuffle trees, so p
// here is bitwise the p of KA's forward), and the train form saves no T x T
// matrix (2.0 GB a block at transformer32's plane in bf16).
//
// Bound on the H100: bytes at the transformer's shapes. One sequence of
// T = 31 tokens x 128 columns reads q, k, v, dout and writes dq, dk, dv
// (7 x 7.9 KB in bf16) for ~1.5 MFLOP, ~27 FLOP a byte, far below the
// card's ~295 bf16 FLOP a byte.
// Design, bf16 (attention_staged_bwd_pack_tc at T <= 64,
// attention_staged_bwd_tc past it; attention_staged.cuh): tensor cores,
// each warpgroup a 64-row tile. At T <= 64 one kernel: a tile packs items
// as the forward packs them and holds every key, the logits and dp, the
// exact softmax, the Sigma term and dl in registers, dq = dl . k from dl in
// the register A operand, dk and dv from p^T and dl^T in shared memory.
// Past T 64 a block per item, V, Q, K and dout staged in shared memory once:
// phase A, each warpgroup a query tile, the rows' statistics (max, sum, the
// Sigma term) once per query tile into shared memory, then dq; phase B,
// each warpgroup a key tile, dk and dv from the keys' rows of k . q^T and v
// . dout^T, p^T and dl^T from the statistics in the register A operand.
// Head dims 32 and 64, T <= 512 in bf16 at hd 32 and 416 at hd 64
// (ka_staged_tc::plan's shared memory).
// Design, f32 (attention_bwd_kernel): one block per (sequence, head), four
// warps; Q, K, V and dout of
// the head staged in shared memory in the input dtype, every row padded
// by one 32-bit word (lanes reading one column of 32 different rows hit 32
// banks). Pass 1, a warp per query i as in the forward: each lane owns
// keys lane, lane+32, ...: the logits, max and sum as the forward, then
// dp, the Sigma term a by a shuffle tree, dl; then each lane owns hd/32
// columns of dq_i. The row's max, sum and a go to shared memory. Pass 2, a
// warp per key j: each lane owns queries i (i >= j when causal), recomputes
// p_ij and dl_ij from the saved row statistics, and then each lane owns
// hd/32 columns of dk_j and dv_j. T <= 209 at hd 64 (ViT-B/16's T 197
// takes 218,748 bytes) and 393 at hd 32, where the staged rows fit the 227
// KB of shared memory (smem_bytes). models/common.py attn_max_t mirrors
// both instances' shared memory and refuses the rest before a launch.
#include <cmath>

#include "attention_staged.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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

// ---- the bf16 instance: tensor cores (attention_staged.cuh) -----------------

namespace stc = ka_staged_tc;
namespace sp = ka_split_tc;
using stc::bf16;

struct TcArgs {
  const bf16* q; const bf16* k; const bf16* v; const bf16* dout;
  bf16* dq; bf16* dk; bf16* dv;
  int T; int D; int heads; int causal; float scale;
  long long items; long long blocks; int lg; int vec; int pairs; int vout;
};

// T <= 64: each warpgroup one packed tile (items as the forward packs
// them), every key in it: the logits and dp = dout . v^T (m64n64 each), the
// exact softmax of each row, the Sigma term a = sum_k (dp_k / s^2) e_k in the
// reference's order, dl; dq = dl . k from dl in the register A operand; p^T
// and dl^T into the warpgroup's bf16 tiles in shared memory, then dk = dl^T
// . q and dv = p^T . dout; each output stored once. The block's next tiles
// load into the other stage under this one's products.
template <int HD>
__global__ void __launch_bounds__(stc::kThreads, HD == 32 ? 2 : 1)
attention_staged_bwd_pack_tc(const TcArgs a) {
  constexpr int TL = stc::kRows * HD;      // elements of a tile
  constexpr int SZ = 4 * stc::kWG * TL;    // a stage: q, k, v, dout tiles of every warpgroup
  constexpr int PT = stc::kRows * stc::kRows;
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[stc::kWG * sp::kMaxItems];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  const int T = a.T, D = a.D, lg = a.lg, msk = (1 << lg) - 1;
  const int G = stc::kRows >> lg, ipb = stc::kWG * G;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float scale = a.scale;
  const stc::Keep keep = stc::packed_keep(r_lo, lg, T, a.causal);
  bf16* pt = ring + 2 * SZ + wg * 2 * PT;  // p^T of the warpgroup's tile (rows keys)
  bf16* lt = pt + PT;                       // dl^T
  auto load = [&](long long b, int stage) {
    bf16* dst = ring + stage * SZ;
    const long long it0 = b * ipb;
    const bf16* x[4] = {a.q, a.k, a.v, a.dout};
    if (a.vec) {
      const long long off = stc::packed_offset<HD>(it0, a.items, lg, T, D, a.heads);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        stc::load_packed<HD>(dst + m * stc::kWG * TL, x[m], off, lg, T, D);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        stc::load_packed_elems<HD>(dst + m * stc::kWG * TL, x[m], it0, a.items, lg, T, D, a.heads);
    }
  };

  static_assert(stc::kStages == 2, "one block's tiles in flight");
  if (blockIdx.x < a.blocks) load(blockIdx.x, 0);
  mt::cp_commit();
  int n = 0;
  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x, ++n) {
    if (b + gridDim.x < a.blocks) load(b + gridDim.x, (n + 1) & 1);
    mt::cp_commit();
    if (threadIdx.x < ipb) {
      const long long it = b * ipb + threadIdx.x;
      ib[threadIdx.x] = it < a.items ? sp::item_base(it, T, D, HD, a.heads) : 0;
    }
    mt::cp_wait<1>();
    __syncthreads();
    const long long it0 = b * ipb + wg * G;
    const int ng = static_cast<int>(a.items - it0 < G ? a.items - it0 : G);
    if (ng > 0) {
      bf16* st = ring + (n & 1) * SZ + wg * TL;
      bf16 *qt = st, *kt = st + stc::kWG * TL, *vt = st + 2 * stc::kWG * TL,
           *ot = st + 3 * stc::kWG * TL;
      float s[8][4], dp[8][4], mx[2], sum[2];
      sp::chunk_dots2<HD>(s, dp, qt, kt, ot, vt, 0);
      stc::scale_keep<false>(s, qc, scale, keep);
      stc::softmax_exact(s, mx, sum);  // s: e = exp(l - max), 0 where the key is dropped
      stc::round_dp(dp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_lo + 8 * r;
        const float is2 = __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r])), rs = mt::rcp(sum[r]);
        float sg = 0.0f;  // a dropped key adds (dp / s^2) exp(-inf) = 0
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e)
            sg = __fadd_rn(sg, __fmul_rn(__fmul_rn(dp[c8][e], is2), s[c8][e]));
        sg = mt::quad_sum(sg);
        // a padding row (past T or past the items) adds nothing to dk, dv
        const bool ok = (row >> lg) < ng && (row & msk) < T;
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          float p[2], w[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float e = s[c8][2 * r + h];
            p[h] = ok ? mt::div(e, sum[r], rs) : 0.0f;
            w[h] = stc::dl_of(ok && e != 0.0f, e, dp[c8][2 * r + h], sum[r], rs, sg, scale);
          }
          mt::rc2(p[0], p[1]);
          mt::rc2(w[0], w[1]);
          const int col = 8 * c8 + qc;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[c8][2 * r + h] = w[h];
            pt[mt::tile_at<stc::kRows>(col + h, row)] = __float2bfloat16_rn(p[h]);
            lt[mt::tile_at<stc::kRows>(col + h, row)] = __float2bfloat16_rn(w[h]);
          }
        }
      }
      mt::fence_async();
      // each output through a tile its products have read by then (dq: v's,
      // dk: k's, dv: q's), in 16-byte stores; else from the fragments
      const sp::Rows rw{ib + wg * G, ng, lg};
      auto out = [&](bf16* y, bf16* via, const float (&g)[HD / 8][4]) {
        if (a.vout)
          stc::frag_to_tile<HD>(via, g, r_lo, qc);
        else
          sp::store_rows<HD / 8>(y, g, rw, 0, r_lo, qc, 0, T, D, HD, a.pairs);
      };
      float g[HD / 8][4];
      sp::zero(g);
      mt::mul_acc<HD, HD / 8, 4>(g, s, kt, 0);  // dq = dl . k
      out(a.dq, vt, g);
      stc::wg_sync(wg);  // the warpgroup's p^T and dl^T are written
      stc::smem_mul<HD>(g, lt, qt);  // dk = dl^T . q
      out(a.dk, kt, g);
      stc::smem_mul<HD>(g, pt, ot);  // dv = p^T . dout
      out(a.dv, qt, g);
      if (a.vout) {
        stc::wg_sync(wg);
        stc::store_packed<HD>(a.dq, vt, rw.ib, ng, lg, T, D);
        stc::store_packed<HD>(a.dk, kt, rw.ib, ng, lg, T, D);
        stc::store_packed<HD>(a.dv, qt, rw.ib, ng, lg, T, D);
      }
    }
    __syncthreads();
  }
}

// T > 64: a block per item, its V, Q, K and dout staged in shared memory
// once (V's rows to a multiple of 8: a key tile read past them lands in Q's
// rows, which only dropped keys and unstored rows see). Phase A, each
// warpgroup a query tile: pass 1 the rows' max, sum of exp and ad = sum dp
// e (online over the key tiles), a = ad / s^2, the rows' (max, sum, a, 1/sum)
// into shared memory; pass 2 dl into the register A operand of dq += dl .
// k, stored once. Phase B, each warpgroup a key tile (from its own query
// tile on under the causal mask): k . q^T and v . dout^T with the keys as
// rows, p^T and dl^T from the query columns' statistics into the register A
// operands of dv += p^T . dout and dk += dl^T . q, stored once.
template <int HD>
__global__ void __launch_bounds__(stc::kThreads, 1) attention_staged_bwd_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int T = a.T, D = a.D, causal = a.causal, R = stc::pad64(T), ntq = R / stc::kRows;
  bf16* vs = reinterpret_cast<bf16*>(smraw);
  bf16* qs = vs + stc::pad8(T) * HD;
  bf16* ks = qs + R * HD;
  bf16* os = ks + R * HD;
  float4* stats = reinterpret_cast<float4*>(os + R * HD);  // (max, sum, a, 1/sum) a row
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float ninf = -__int_as_float(0x7f800000), scale = a.scale;
  // a warpgroup's m-th tile of ntq: wg, 2 kWG - 1 - wg, 2 kWG + wg, ...
  auto tile_of = [&](int m) { return m * stc::kWG + ((m & 1) ? stc::kWG - 1 - wg : wg); };

  for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
    const long long base = sp::item_base(it, T, D, HD, a.heads);
    const sp::Rows rw{&base, 1, 6};
    stc::load_rows<HD>(vs, a.v, base, stc::pad8(T), T, D, a.vec);
    stc::load_rows<HD>(qs, a.q, base, R, T, D, a.vec);
    stc::load_rows<HD>(ks, a.k, base, R, T, D, a.vec);
    stc::load_rows<HD>(os, a.dout, base, R, T, D, a.vec);
    mt::cp_commit();
    mt::cp_wait<0>();
    __syncthreads();

    // phase A: query tiles -> the rows' statistics and dq
    for (int m = 0;; ++m) {
      const int i = tile_of(m);
      if (i >= ntq) break;
      const int q0 = i * stc::kRows;
      const int nk = causal ? min(q0 + stc::kRows, T) : T;
      const int ntk = (nk + stc::kRows - 1) / stc::kRows;
      const bf16 *qt = qs + q0 * HD, *ot = os + q0 * HD;
      // key tile j's scaled, masked logits and rounded dp
      auto logits = [&](float (&s)[8][4], float (&dp)[8][4], int j) {
        const int k0 = j * stc::kRows;
        sp::chunk_dots2<HD>(s, dp, qt, ks + k0 * HD, ot, vs + k0 * HD, 0);
        stc::round_dp(dp);
        stc::scale_keep(s, (!causal || j < i) && k0 + stc::kRows <= T, qc, scale,
                        stc::staged_keep(q0 + r_lo, k0, T, causal));
      };
      float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f}, ad[2] = {0.0f, 0.0f};
      for (int j = 0; j < ntk; ++j) {
        float s[8][4], dp[8][4];
        logits(s, dp, j);
        stc::row_stats_dp(s, dp, mx, sum, ad);
      }
      float sg[2], rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sg[r] = __fmul_rn(ad[r], __fdiv_rn(1.0f, __fmul_rn(sum[r], sum[r])));
        rs[r] = mt::rcp(sum[r]);
        if ((lane & 3) == 0) stats[q0 + r_lo + 8 * r] = make_float4(mx[r], sum[r], sg[r], rs[r]);
      }
      float g[HD / 8][4];
      sp::zero(g);
      for (int j = 0; j < ntk; ++j) {
        float s[8][4], dp[8][4];
        logits(s, dp, j);
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = e >> 1;
            float w[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float l = s[c8][e + h];
              w[h] = stc::dl_of(l != ninf, stc::fexp(__fsub_rn(l, mx[r])), dp[c8][e + h], sum[r],
                                rs[r], sg[r], scale);
            }
            mt::rc2(w[0], w[1]);
            s[c8][e] = w[0];
            s[c8][e + 1] = w[1];
          }
        mt::mul_acc<HD, HD / 8, 4>(g, s, ks + j * stc::kRows * HD, 0);
      }
      sp::store_rows<HD / 8>(a.dq, g, rw, q0, r_lo, qc, 0, T, D, HD, a.pairs);
    }
    __syncthreads();  // every row's statistics are in shared memory

    // phase B: key tiles -> dk and dv
    for (int m = 0;; ++m) {
      const int j = tile_of(m);
      if (j >= ntq) break;
      const int k0 = j * stc::kRows;
      const bf16 *kt = ks + k0 * HD, *vt = vs + k0 * HD;
      float gk[HD / 8][4], gv[HD / 8][4];
      sp::zero(gk);
      sp::zero(gv);
      for (int i = causal ? j : 0; i < ntq; ++i) {
        const int q0 = i * stc::kRows;
        float s[8][4], dp[8][4];
        sp::chunk_dots2<HD>(s, dp, kt, qs + q0 * HD, vt, os + q0 * HD, 0);
        stc::round_dp(dp);
        // row r: key k0 + r; column col: query q0 + col
        stc::scale_keep(s, q0 + stc::kRows <= T && k0 + stc::kRows <= T && (!causal || i > j), qc,
                        scale, stc::key_keep(k0 + r_lo, q0, T, causal));
        // p^T and dl^T from the query columns' statistics
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // the thread's two query columns of the chunk
            const float4 q4 = stats[q0 + 8 * c8 + qc + h];
#pragma unroll
            for (int e = h; e < 4; e += 2) {  // keys r_lo, r_lo + 8
              const float l = s[c8][e], x = stc::fexp(__fsub_rn(l, q4.x));
              s[c8][e] = mt::div(x, q4.y, q4.w);
              dp[c8][e] = stc::dl_of(l != ninf, x, dp[c8][e], q4.y, q4.w, q4.z, scale);
            }
          }
          mt::rc2(s[c8][0], s[c8][1]);
          mt::rc2(s[c8][2], s[c8][3]);
          mt::rc2(dp[c8][0], dp[c8][1]);
          mt::rc2(dp[c8][2], dp[c8][3]);
        }
        mt::mul_acc<HD, HD / 8, 4>(gv, s, os + q0 * HD, 0);   // dv += p^T . dout
        mt::mul_acc<HD, HD / 8, 4>(gk, dp, qs + q0 * HD, 0);  // dk += dl^T . q
      }
      sp::store_rows<HD / 8>(a.dk, gk, rw, k0, r_lo, qc, 0, T, D, HD, a.pairs);
      sp::store_rows<HD / 8>(a.dv, gv, rw, k0, r_lo, qc, 0, T, D, HD, a.pairs);
    }
    __syncthreads();  // every warpgroup is done with the item's rows
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dv, int N, int T, int heads, int causal, cudaStream_t stream) {
  const long long items = static_cast<long long>(N) * heads;
  const stc::Plan p = stc::plan<HD>(items, T);
  if (p.bwd_smem > sp::kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = p.packed ? attention_staged_bwd_pack_tc<HD> : attention_staged_bwd_tc<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.bwd_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t in = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const uintptr_t out = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                        reinterpret_cast<uintptr_t>(dv);
  TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
           static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, heads * HD, heads, causal,
           static_cast<float>(1.0 / sqrt(static_cast<double>(HD))), items, p.blocks, p.lg,
           (in & 15) == 0, (out & 3) == 0, (out & 15) == 0};
  kernel<<<stc::grid_of(kernel, p, p.bwd_smem), stc::kThreads, p.bwd_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [N, T, heads * hd] in the compute dtype (kind
// KIND_F32 or KIND_BF16); hd 32 or 64; 1 <= T <= 512 (and each instance's
// staged rows within 227 KB of shared memory).
extern "C" int sw_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, int N, int T, int heads, int hd,
                                int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || T > 512 || heads < 1 || heads > 65535 || (hd != 32 && hd != 64) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    return hd == 32 ? launch_tc<32>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st)
                    : launch_tc<64>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st);
  }
  return hd == 32 ? launch_kab<float, 32>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st)
                  : launch_kab<float, 64>(q, k, v, dout, dq, dk, dv, N, T, heads, causal, st);
}
