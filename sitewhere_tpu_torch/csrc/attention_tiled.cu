// KA, tiled form: scaled dot-product attention with an f32 softmax at any
// head dim from 1 to 256 and any sequence length, its shared memory
// independent of T. Heads are split by column of [N, T, heads * hd] rows.
//
// Replaces sitewhere_tpu/models/common.py:61 attn_core where the staged
// form (attention.cu: hd 32 and 64, all T rows of K and V in shared memory)
// does not take the shape: other head dims (ViT-H/14's 80, the reference's
// test widths 8 and 16) and longer sequences (ViT-B/16 at 384: T 577). The
// rounding points are attention.cu's: QK^T accumulated in f32 and rounded
// to the compute dtype, then scaled by 1/sqrt(hd) in f32; under the causal
// mask keys past i give exp() = 0; the softmax is f32, each p rounded to
// the compute dtype after the division by the row's sum; p.v accumulated
// in f32 and rounded once into the output. Two passes over the keys, not
// one online pass over unnormalized p: the reference rounds p after the
// normalization.
//
// Bound on the H100: at ViT-B/16 at 384 (64 x 577 x 12 x 64, bf16) the
// function reads q, k, v and writes the output, 227 MB (0.068 ms at 3.35
// TB/s), and does 4 T^2 hd FLOP a (sequence, head), 65 GFLOP (0.066 ms at
// the bf16 tensor rate): bytes bound it.
//
// bf16 (attention_tiled_tc): every product on the tensor cores (wgmma
// m64nNk16, bf16 in, f32 accumulators). A block is two warpgroups, 64
// query rows each, whose 128 rows share each key/value tile: the tiles
// stream from L2 through a ring of shared-memory stages (cp.async, the next
// tiles' copies in flight under the current tile's products), which is what
// the time is spent on at T 577: the two passes read every key tile twice
// and every value tile once a query tile, so the 128-row tile halves those
// bytes against a 64-row one. Pass 1 takes q.k^T for each row's max and sum
// of exp (online); pass 2 recomputes the same products (the same bits),
// rounds p in the logits' registers and feeds them to p.v as wgmma's
// register operand (mma_tiles.cuh). Every product's shape is a compile-time
// constant (head dims below the instantiation's width run on zero columns),
// so the products stay in flight together.
//
// f32 (attention_tiled_kernel): CUDA cores, one block per (sequence, head,
// query tile), four warps of RW rows; key and value tiles of 32 rows
// through shared memory (f32, rows padded by four words). Pass 1, a lane
// per key: each row's max and sum of exp by an online rescale; pass 2
// recomputes the logits with the same arithmetic, forms p for the tile,
// and each lane accumulates its hd/32 output columns of p.v. f32 products
// stay off the tensor cores: TF32 would miss the 2e-4 bar against float64.
// A causal block stops at the key tile of its last query.
#include <cmath>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 32;  // keys a tile: one a lane

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

// HQ output columns a lane (head dims up to HDM = 32 HQ); RW query rows a
// warp, so a lane holds RW x HQ = 16 accumulators.
template <int HQ>
struct Tiles {
  static constexpr int HDM = 32 * HQ;
  static constexpr int RS = HDM + 4;  // padded row stride of a key/value tile
  static constexpr int RW = 16 / HQ;
  static constexpr int BQ = kWarps * RW;
};

template <int HQ>
size_t fwd_smem_bytes() {
  using S = Tiles<HQ>;
  return (2 * static_cast<size_t>(kKeys) * S::RS + static_cast<size_t>(S::BQ) * S::HDM +
          static_cast<size_t>(kWarps) * S::RW * kKeys) *
         sizeof(float);
}

// Rows [j0, j0 + n) of x (columns < hd; the rest, and rows past `valid`,
// 0) into a tile of `n` rows of stride `stride` floats.
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

// The f32 dot products of the warp's RW query rows qw (stride HDM) with
// the lane's key row kr, d ascending, over hd4 = hd rounded up to 4
// (the padding is 0).
template <int HQ>
__device__ __forceinline__ void row_dots(const float* qw, const float* kr, int hd4,
                                         float (&l)[Tiles<HQ>::RW]) {
  using S = Tiles<HQ>;
#pragma unroll
  for (int r = 0; r < S::RW; ++r) l[r] = 0.0f;
  for (int d = 0; d < hd4; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
    for (int r = 0; r < S::RW; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qw + r * S::HDM + d);
      l[r] = fmaf(qv.x, kv.x, l[r]);
      l[r] = fmaf(qv.y, kv.y, l[r]);
      l[r] = fmaf(qv.z, kv.z, l[r]);
      l[r] = fmaf(qv.w, kv.w, l[r]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int HQ>
__global__ void __launch_bounds__(kWarps * 32)
attention_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int Tn, int D, int hd, int causal, float scale,
                       int qtiles) {
  using S = Tiles<HQ>;
  constexpr int HDM = S::HDM, RS = S::RS, RW = S::RW, BQ = S::BQ;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                  // [kKeys][RS]
  float* vs = ks + kKeys * RS;     // [kKeys][RS]
  float* qs = vs + kKeys * RS;     // [BQ][HDM]
  float* ps = qs + BQ * HDM;       // [kWarps][RW][kKeys]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd4 = (hd + 3) & ~3;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(blockIdx.y) * hd;
  float* pw = ps + warp * RW * kKeys;
  const float* qw = qs + warp * RW * HDM;
  const float ninf = -__int_as_float(0x7f800000);

  for (int qt = blockIdx.z; qt < qtiles; qt += gridDim.z) {
    const int q0 = qt * BQ;
    const int i0 = q0 + warp * RW;  // the warp's first query
    __syncthreads();
    // the tile's queries (rows past T repeat the last one; never stored)
    for (int e = threadIdx.x; e < BQ * HDM; e += blockDim.x) {
      const int r = e / HDM, d = e - r * HDM;
      const int i = min(q0 + r, Tn - 1);
      qs[e] = d < hd ? to_f(q[base + static_cast<long long>(i) * D + d]) : 0.0f;
    }
    const int nk = causal ? min(q0 + BQ, Tn) : Tn;  // keys any row of the tile sees
    float mx[RW], sum[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      mx[r] = ninf;
      sum[r] = 0.0f;
    }
    // pass 1: each row's max and sum of exp, rescaled online
    for (int j0 = 0; j0 < nk; j0 += kKeys) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kKeys, nk, hd, HDM, RS, D);
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
    // pass 2: p = rc(exp(l - max) / sum) a tile at a time, p.v by column
    float acc[RW][HQ];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < HQ; ++c) acc[r][c] = 0.0f;
    for (int j0 = 0; j0 < nk; j0 += kKeys) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kKeys, nk, hd, HDM, RS, D);
      stage_rows(vs, v, base, j0, kKeys, nk, hd, HDM, RS, D);
      __syncthreads();
      float l[RW];
      row_dots<HQ>(qw, ks + lane * RS, hd4, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = __fmul_rn(rc<T>(l[r]), scale);
        pw[r * kKeys + lane] = ok ? rc<T>(__fdiv_rn(expf(__fsub_rn(lr, mx[r])), sum[r])) : 0.0f;
      }
      __syncwarp();
      const int kn = min(kKeys, nk - j0);
      for (int jj = 0; jj < kn; ++jj) {
        float vv[HQ];
#pragma unroll
        for (int c = 0; c < HQ; ++c) vv[c] = vs[jj * RS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float p = pw[r * kKeys + jj];
#pragma unroll
          for (int c = 0; c < HQ; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
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
        if (d < hd) put(out + row + d, acc[r][c]);
      }
    }
  }
}

template <typename T, int HQ>
int launch_tiled(const void* q, const void* k, const void* v, void* out, int N, int Tn,
                 int heads, int hd, int causal, cudaStream_t stream) {
  using S = Tiles<HQ>;
  const size_t smem = fwd_smem_bytes<HQ>();
  cudaError_t err = cudaFuncSetAttribute(attention_tiled_kernel<T, HQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const int qtiles = (Tn + S::BQ - 1) / S::BQ;
  const dim3 grid(N, heads, qtiles < 65535 ? qtiles : 65535);
  attention_tiled_kernel<T, HQ><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, heads * hd, hd, causal, scale, qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, void* out, int N, int Tn, int heads,
                int hd, int causal, cudaStream_t st) {
  if (hd <= 32) return launch_tiled<T, 1>(q, k, v, out, N, Tn, heads, hd, causal, st);
  if (hd <= 64) return launch_tiled<T, 2>(q, k, v, out, N, Tn, heads, hd, causal, st);
  if (hd <= 128) return launch_tiled<T, 4>(q, k, v, out, N, Tn, heads, hd, causal, st);
  return launch_tiled<T, 8>(q, k, v, out, N, Tn, heads, hd, causal, st);
}

// ---- the bf16 instance: tensor cores ----------------------------------------
//
// HDM the widest head dim of the instantiation (32, 64, 128, 256), the
// tiles' column count; a block of WG warpgroups takes 64 query rows a
// warpgroup, 16 a warp, and streams key/value tiles of BK rows through a
// ring of NS stages that its warpgroups share.
template <int HDM>
struct TcTiles {
  static constexpr int WG = 2;
  static constexpr int BQ = 64 * WG;
  static constexpr int BK = HDM > 128 ? 32 : 64;
  static constexpr int NS = HDM > 64 ? 2 : 3;
  static constexpr int SC = BK / 8;   // 8-key chunks of a logit tile
  static constexpr int OC = HDM / 8;  // 8-column chunks of an output row
};

template <int HDM>
size_t tc_smem_bytes() {
  using S = TcTiles<HDM>;
  return static_cast<size_t>(S::BQ + 2 * S::NS * S::BK) * HDM * sizeof(__nv_bfloat16);
}

// One block per (sequence, head, query tile), two passes over the key
// tiles run as one sequence of steps through the ring, the copies of the
// next NS - 1 steps in flight under the current step's products. Pass 1
// keeps each row's max and sum of exp online; pass 2 (key and value tiles)
// recomputes the same logits (the same products in the same order: the same
// bits), forms p = rc(exp(l - max) / sum) in the logits' registers and
// feeds it as the register A operand of p . v.
template <int HDM>
__global__ void __launch_bounds__(TcTiles<HDM>::WG * 128)
attention_tiled_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Tn,
                   int D, int hd, int causal, float scale, int qtiles, long long tiles, int vec) {
  using S = TcTiles<HDM>;
  using mt::bf16;
  constexpr int BQ = S::BQ, BK = S::BK, NS = S::NS, SC = S::SC, OC = S::OC;
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* qs = reinterpret_cast<bf16*>(smraw);  // [BQ] rows
  bf16* ks = qs + BQ * HDM;                   // [NS][BK] rows
  bf16* vs = ks + NS * BK * HDM;              // [NS][BK] rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int heads = D / hd;
  const float ninf = -__int_as_float(0x7f800000);
  const bf16* qg = qs + (warp >> 2) * 64 * HDM;  // the warpgroup's 64 query rows

  // blocks in (sequence, head, query tile) order, the query tile fastest:
  // the tiles of one (sequence, head) run side by side and share its keys
  // and values through L2
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int qt = static_cast<int>(b % qtiles);
    const long long sh = b / qtiles;
    const long long base = (sh / heads) * Tn * D + (sh % heads) * hd;
    const int q0 = qt * BQ;
    const int w0 = q0 + warp * 16;  // the warp's first row
    const bool live = w0 < Tn;
    const int i_lo = min(w0 + (lane >> 2), Tn - 1), i_hi = min(w0 + (lane >> 2) + 8, Tn - 1);
    const int nk = causal ? min(q0 + BQ, Tn) : Tn;             // keys the tile's rows see
    const int kend = causal ? min(min(w0 + 16, Tn), nk) : nk;  // ... the warp's rows
    const int ntiles = (nk + BK - 1) / BK, nsteps = 2 * ntiles;
    // the mask of tile j0: is it full for the warp's rows, and the last
    // column each of the lane's rows keeps
    const int qc = (lane & 3) * 2;
    auto full = [&](int j0) { return causal ? j0 + BK - 1 <= w0 : j0 + BK <= Tn; };
    auto lim = [&](int j0, int i) { return (causal ? i : Tn - 1) - j0 - qc; };
    // step st: key tile st % ntiles, with its value tile in pass 2
    auto load_step = [&](int st) {
      const int j0 = (st % ntiles) * BK, at = (st % NS) * BK * HDM;
      mt::load_tile<HDM>(ks + at, k, base, j0, BK, nk, hd, D, vec);
      if (st >= ntiles) mt::load_tile<HDM>(vs + at, v, base, j0, BK, nk, hd, D, vec);
    };

    __syncthreads();  // every warp is done with the previous tile's buffers
    mt::load_tile<HDM>(qs, q, base, q0, BQ, Tn, hd, D, vec);
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < nsteps) load_step(st);
      mt::cp_commit();
    }
    float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f}, rs[2];
    float o[OC][4];
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.0f;
    for (int st = 0; st < nsteps; ++st) {
      if (st + NS - 1 < nsteps) load_step(st + NS - 1);
      mt::cp_commit();
      mt::cp_wait<NS - 1>();
      __syncthreads();
      const int at = (st % NS) * BK * HDM;
      float s[SC][4];
      mt::dots<HDM, SC>(s, qg, ks + at);
      if (st < ntiles) {
        // pass 1: each row's max and sum of exp, rescaled online
        const int j0 = st * BK;
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
        // pass 2: p = rc(exp(l - max) / sum) a tile at a time, o += p . v
        const int j0 = (st - ntiles) * BK;
        if (st == ntiles) {
          rs[0] = mt::rcp(sum[0]);
          rs[1] = mt::rcp(sum[1]);
        }
        mt::scale_logits(s, full(j0), lim(j0, i_lo), lim(j0, i_hi), scale);
#pragma unroll
        for (int c = 0; c < SC; ++c)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = e >> 1;  // a dropped key: exp(-inf) = 0, p = 0
            float p0 = mt::div(expf(__fsub_rn(s[c][e], mx[r])), sum[r], rs[r]);
            float p1 = mt::div(expf(__fsub_rn(s[c][e + 1], mx[r])), sum[r], rs[r]);
            mt::rc2(p0, p1);
            s[c][e] = p0;
            s[c][e + 1] = p1;
          }
        mt::mul_acc<HDM, OC, BK / 16>(o, s, vs + at, 0);
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
            out[base + static_cast<long long>(i) * D + d] = __float2bfloat16_rn(o[c][e]);
        }
    }
  }
}

template <int HDM>
int launch_tc(const void* q, const void* k, const void* v, void* out, int N, int Tn, int heads,
              int hd, int causal, cudaStream_t stream) {
  using S = TcTiles<HDM>;
  const size_t smem = tc_smem_bytes<HDM>();
  cudaError_t err = cudaFuncSetAttribute(attention_tiled_tc<HDM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const int qtiles = (Tn + S::BQ - 1) / S::BQ;
  const int vec = hd % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const long long tiles = static_cast<long long>(N) * heads * qtiles;
  attention_tiled_tc<HDM><<<static_cast<unsigned>(tiles < mt::kMaxGrid ? tiles : mt::kMaxGrid),
                            S::WG * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Tn, heads * hd, hd,
      causal, scale, qtiles, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

int by_head_dim_tc(const void* q, const void* k, const void* v, void* out, int N, int Tn,
                   int heads, int hd, int causal, cudaStream_t st) {
  if (hd <= 32) return launch_tc<32>(q, k, v, out, N, Tn, heads, hd, causal, st);
  if (hd <= 64) return launch_tc<64>(q, k, v, out, N, Tn, heads, hd, causal, st);
  if (hd <= 128) return launch_tc<128>(q, k, v, out, N, Tn, heads, hd, causal, st);
  return launch_tc<256>(q, k, v, out, N, Tn, heads, hd, causal, st);
}

}  // namespace

// q, k, v, out: [N, T, heads * hd] in the compute dtype (kind KIND_F32 or
// KIND_BF16); 1 <= hd <= 256; any T >= 1.
extern "C" int sw_attention_tiled(const void* q, const void* k, const void* v, void* out, int N,
                                  int T, int heads, int hd, int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || T < 1 || heads < 1 || heads > 65535 || hd < 1 || hd > 256 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? by_head_dim_tc(q, k, v, out, N, T, heads, hd, causal, st)
                           : by_head_dim<float>(q, k, v, out, N, T, heads, hd, causal, st);
}
