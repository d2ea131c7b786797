// KA, split form: scaled dot-product attention with an f32 softmax at head
// dims past 256 (any hd), any sequence length. Heads are split by column of
// [N, T, heads * hd] rows.
//
// Replaces sitewhere_tpu/models/common.py:61 attn_core where the tiled form
// (attention_tiled.cu, hd 1..256) does not take the head dim: a
// transformer at dim 512 with one head (hd 512), or hd 288 / 300. The
// rounding points are attention_tiled.cu's: QK^T accumulated in f32 and
// rounded to the compute dtype, then scaled by 1/sqrt(hd) in f32; under
// the causal mask keys past i give exp() = 0; the softmax is f32, each p
// rounded to the compute dtype after the division by the row's sum; p.v
// accumulated in f32 and rounded once into the output.
//
// Design, bf16 (attention_split_one_tc, attention_split_tc;
// attention_split.cuh ka_split_tc, mma_tiles.cuh): tensor cores. A block is
// one warpgroup and a tile of 64 query rows with ALL of its output columns;
// q, k and v stream through a ring of four 16 KB stages (cp.async, 16, 8 or
// 4 bytes a copy as the row pitch allows: hd 300 takes 8; element by
// element where it allows none: hd 257), each input read once a tile, and
// every product is a compile-time m64n64k16 wgmma over a 64-column chunk,
// so any hd runs on the same code (only the step count is a runtime value).
// At T <= 64 (attention_split_one_tc) the tile packs 64 / 2^lg items
// ((sequence, head); 2^lg >= max(T, 8)) under a block-diagonal mask: main
// path p's two sequences of 31. The logits accumulate in f32 over the full
// head dim once, the softmax is exact (the max, then the sum of exp), p =
// rc(e / s) goes to a bf16 tile in shared memory, and each 128 output
// columns o = p . v is stored once. Three blocks an SM. Past one key tile
// (attention_split_tc) a block per (item, query tile): pass 1 the rows' max
// and sum (online), pass 2 the logits again and each key tile's p into a
// cache of the tile's p rows (one tile, recomputed before each product,
// past what fits: T > 1,280), then out += p . v over the key tiles per 128
// columns. No atomics: two runs are bitwise equal.
//
// f32 (attention_split_kernel, ka_split): CUDA cores, one block per
// (sequence, head, column chunk of 256, query tile of 8 rows), four warps
// of two rows, a lane 8 of the chunk's columns. Pass 1, a lane per key of a
// 32-key tile: the logits over the full head dim (q and k streamed 256
// columns at a time, one f32 sum continued), each row's max and sum of exp
// by an online rescale over the key tiles. Pass 2 recomputes the logits,
// forms p = rc(exp(l - max) / sum) for the tile, stages the tile's values
// of the block's own columns and accumulates p.v. Every chunk's block
// computes the same p. A causal block stops at the key tile of its last
// query. Grid (N, heads x chunks, query tiles; the last dim a grid-stride
// loop past 65,535 tiles). f32 products stay off the tensor cores: TF32
// would miss the 2e-4 bar against float64.
//
// Bound on the H100: at the transformer's dim 512, one head (65,536 x 31
// x 512, bf16, causal) the function reads q, k, v and writes the output,
// 8.3 GB (2.48 ms at 3.35 TB/s), and does 4 hd FLOP a (query, key) pair of
// the causal triangle, 67 GFLOP (0.07 ms at the bf16 tensor rate): bytes.
// The bf16 form there: 4.52 ms on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py split_attention_phase), 1.82x the bound (the
// CUDA-core form: 140.7 ms). Its time is each block's serial phases (the
// first stages' latency, the softmax, the stores) more than bytes, so it
// holds three blocks an SM (at most 168 registers, 72 KB of shared memory
// each); fewer blocks with deeper rings ran slower (PERF.md section 6).
#include <cmath>

#include "attention_split.cuh"

namespace {

using namespace ka_split;

size_t fwd_smem_bytes() {
  return (2 * static_cast<size_t>(kTile) * kRS + static_cast<size_t>(kBR) * kChunk +
          static_cast<size_t>(kWarps) * kRW * kTile) *
         sizeof(float);
}

struct FwdArgs {
  const void* q; const void* k; const void* v; void* out;
  int Tn; int D; int hd; int heads; int chunks; int causal; float scale; int qtiles;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) attention_split_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                   // [kTile][kRS] a key chunk
  float* vs = ks + kTile * kRS;     // [kTile][kRS] the tile's values, own columns
  float* qs = vs + kTile * kRS;     // [kBR][kChunk] a query chunk
  float* ps = qs + kBR * kChunk;    // [kWarps][kRW][kTile]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const int head = blockIdx.y / a.chunks;
  const int own = (blockIdx.y - head * a.chunks) * kChunk;  // the block's first column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(head) * hd;
  float* pw = ps + warp * kRW * kTile;
  const float* qw = qs + warp * kRW * kChunk;
  const float ninf = -__int_as_float(0x7f800000);

  for (int qt = blockIdx.z; qt < a.qtiles; qt += gridDim.z) {
    const int q0 = qt * kBR;
    const int i0 = q0 + warp * kRW;
    const int nk = causal ? min(q0 + kBR, Tn) : Tn;
    // the raw logits of the warp's rows with key j0 + lane, over the full
    // head dim (rows past T repeat the last query; never stored)
    auto logits = [&](int j0, float (&l)[kRW]) {
#pragma unroll
      for (int r = 0; r < kRW; ++r) l[r] = 0.0f;
      for (int c0 = 0; c0 < hd; c0 += kChunk) {
        __syncthreads();
        stage_cols(qs, q, base, q0, kBR, Tn, true, c0, hd, kChunk, D);
        stage_cols(ks, k, base, j0, kTile, nk, false, c0, hd, kRS, D);
        __syncthreads();
        dots_acc(qw, kChunk, ks + lane * kRS, chunk_w4(c0, hd), l);
      }
    };
    float mx[kRW], sum[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      mx[r] = ninf;
      sum[r] = 0.0f;
    }
    // pass 1: each row's max and sum of exp, rescaled online
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW];
      logits(j0, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = ok ? __fmul_rn(rc<T>(l[r]), a.scale) : ninf;
        const float nm = fmaxf(mx[r], warp_max(lr));
        const float e = ok ? expf(__fsub_rn(lr, nm)) : 0.0f;
        sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), warp_sum(e));
        mx[r] = nm;
      }
    }
    // pass 2: p a tile at a time, p.v over the block's own columns
    float acc[kRW][kHQ];
#pragma unroll
    for (int r = 0; r < kRW; ++r)
#pragma unroll
      for (int c = 0; c < kHQ; ++c) acc[r][c] = 0.0f;
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW];
      logits(j0, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = __fmul_rn(rc<T>(l[r]), a.scale);
        pw[r * kTile + lane] =
            ok ? rc<T>(__fdiv_rn(expf(__fsub_rn(lr, mx[r])), sum[r])) : 0.0f;
      }
      // every warp is past this tile's last read of vs (the logits' syncs)
      stage_cols(vs, v, base, j0, kTile, nk, false, own, hd, kRS, D);
      __syncthreads();
      const int kn = min(kTile, nk - j0);
      for (int jj = 0; jj < kn; ++jj) {
        float vv[kHQ];
#pragma unroll
        for (int c = 0; c < kHQ; ++c) vv[c] = vs[jj * kRS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float p = pw[r * kTile + jj];
#pragma unroll
          for (int c = 0; c < kHQ; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
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
        if (d < hd) put(static_cast<T*>(a.out) + row + d, acc[r][c]);
      }
    }
  }
}

template <typename T>
int launch_split(FwdArgs a, int N, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(attention_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.hd)));
  a.chunks = (a.hd + kChunk - 1) / kChunk;
  a.qtiles = (a.Tn + kBR - 1) / kBR;
  const dim3 grid(N, a.heads * a.chunks, a.qtiles < 65535 ? a.qtiles : 65535);
  attention_split_kernel<T><<<grid, kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 instance: tensor cores ----------------------------------------

namespace tc = ka_split_tc;
using tc::bf16;

constexpr int kNS = 4;                 // ring stages
constexpr int kStage = 2 * tc::kTile;  // a stage: a q and a k chunk, or a 64 x 128 value tile
enum { kStat = 0, kFill = 1, kPV = 2 };

struct TcArgs {
  const bf16* q; const bf16* k; const bf16* v; bf16* out;
  int T; int D; int hd; int heads; int causal; float scale;
  long long items; long long blocks;
  int lg; int tiles; int nch; int vw; int pairs; int res;
};

// T <= 64, one key tile: a block per tile of 64 rows (2..8 items packed
// under a block-diagonal mask at T <= 32), one warpgroup. Its steps
// stream through a ring of kNS stages, the copies of the next kNS - 1 in
// flight under the current step's products: first the logits over the head
// dim's 64-column chunks (q and k), accumulated in registers; then the
// exact softmax, p = rc(exp(l - max) / sum) into a bf16 tile; then for each
// 128 output columns o = p . v (the value tile's columns), stored once. Two
// loops, so the logits and the output chunk are never live together.
// Three blocks an SM (registers capped at 168): the time here is each
// block's serial phases, which the other blocks' steps fill.
__global__ void __launch_bounds__(tc::kThreads, 3) attention_split_one_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[tc::kMaxItems];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  bf16* pt = ring + kNS * kStage;  // p
  const int T = a.T, D = a.D, hd = a.hd, causal = a.causal, lg = a.lg, nch = a.nch, vw = a.vw;
  const int msk = (1 << lg) - 1, G = tc::kRows >> lg, nsteps = nch + (hd + 127) / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float ninf = -__int_as_float(0x7f800000);

  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    const long long it0 = b * G;
    const tc::Rows rw{ib, static_cast<int>(min(static_cast<long long>(G), a.items - it0)), lg};
    // step st < nch: q and k chunk st; past it the value tile of output
    // columns [128 (st - nch), + 128)
    auto load = [&](int st) {
      bf16* dst = ring + (st % kNS) * kStage;
      if (st < nch) {
        tc::load_tile<tc::kDC>(dst, a.q, rw, 0, T, D, hd, st * tc::kDC, vw);
        tc::load_tile<tc::kDC>(dst + tc::kTile, a.k, rw, 0, T, D, hd, st * tc::kDC, vw);
      } else {
        tc::load_tile<128>(dst, a.v, rw, 0, T, D, hd, (st - nch) * 128, vw);
      }
    };
    auto next = [&](int st) {  // the ring's turn before step st's products
      if (st + kNS - 1 < nsteps) load(st + kNS - 1);
      mt::cp_commit();
      mt::cp_wait<kNS - 1>();
      __syncthreads();
    };

    __syncthreads();  // every thread is done with the previous tile's buffers
    if (threadIdx.x < G)
      ib[threadIdx.x] = tc::item_base(it0 + threadIdx.x, T, D, hd, a.heads);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kNS - 1; ++st) {
      if (st < nsteps) load(st);
      mt::cp_commit();
    }
    float s[8][4];
    for (int st = 0; st < nch; ++st) {
      next(st);
      tc::chunk_dots(s, ring + (st % kNS) * kStage, ring + (st % kNS) * kStage + tc::kTile, st);
      __syncthreads();
    }
    // the same item, and under the causal mask no later position
    tc::scale_mask(s, r_lo, qc, a.scale, [&](int r, int col) {
      return (r >> lg) == (col >> lg) && (col & msk) < T && (!causal || (col & msk) <= (r & msk));
    });
    float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f};
    tc::row_stats(s, mx, sum);
    tc::fill_p(s, mx, sum, pt, r_lo, qc);
    for (int st = nch; st < nsteps; ++st) {
      next(st);
      const bf16* vt = ring + (st % kNS) * kStage;
      float o[16][4];
      mt::wg_fence();
      tc::tile_mul<128>(*reinterpret_cast<float(*)[8][4]>(&o[0][0]), pt, vt, 0, 0);
      tc::tile_mul<128>(*reinterpret_cast<float(*)[8][4]>(&o[8][0]), pt, vt, 64, 0);
      mt::wg_commit();
      mt::wg_wait();
      mt::pin(o);
      tc::store_rows<16>(a.out, o, rw, 0, r_lo, qc, (st - nch) * 128, T, D, hd, a.pairs);
      __syncthreads();
    }
  }
}

// T > 64: one block per (item, query tile of 64 rows), one warpgroup, the
// steps of three phases through one ring of kNS stages:
//   1. each row's max and sum of exp (online), the logits of every key tile
//      over the head dim's chunks;
//   2. the logits again, p = rc(exp(l - max) / sum) into the tile's bf16 p
//      cache (every key tile while the cache holds them; else phase 3
//      recomputes each key tile's p before its product, one cache tile);
//   3. for each 128 output columns, out += p . v over the key tiles, then
//      stored once.
// A causal query tile stops at its own key tile, whose first key every row
// sees: no row of a tile is wholly masked.
__global__ void __launch_bounds__(tc::kThreads) attention_split_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[1];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  bf16* pc = ring + kNS * kStage;  // p tiles: [key tile, or 1][64 x 64]
  const int T = a.T, D = a.D, hd = a.hd, causal = a.causal, nch = a.nch, vw = a.vw;
  const int ncc = (hd + 127) / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float ninf = -__int_as_float(0x7f800000);

  // blocks in (item, query tile) order, the query tile fastest: the tiles
  // of one item run side by side and share its keys and values through L2
  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    const long long it = b / a.tiles;
    const int q0 = static_cast<int>(b % a.tiles) * tc::kRows;
    const tc::Rows rw{ib, 1, 6};
    const int nk = causal ? min(q0 + tc::kRows, T) : T;  // keys the tile's rows see
    const int ntk = (nk + tc::kRows - 1) / tc::kRows;
    const int n1 = ntk > 1 ? ntk * nch : 0, n2 = a.res ? ntk * nch : 0;
    const int per = a.res ? 1 : nch + 1;  // steps a key tile takes in phase 3
    const int nsteps = n1 + n2 + ncc * ntk * per;
    // step st -> its kind, key tile j and chunk c (depth, or output columns)
    auto at = [&](int st, int& kind, int& j, int& c) {
      if (st < n1 + n2) {
        kind = st < n1 ? kStat : kFill;
        st -= st < n1 ? 0 : n1;
        j = st / nch;
        c = st - j * nch;
        return;
      }
      st -= n1 + n2;
      const int cc = st / (ntk * per);
      st -= cc * ntk * per;
      j = st / per;
      const int w = st - j * per;
      kind = w < per - 1 ? kFill : kPV;
      c = w < per - 1 ? w : cc;
    };
    auto load = [&](int st) {
      int kind, j, c;
      at(st, kind, j, c);
      bf16* dst = ring + (st % kNS) * kStage;
      if (kind == kPV) {
        tc::load_tile<128>(dst, a.v, rw, j * tc::kRows, T, D, hd, c * 128, vw);
      } else {
        tc::load_tile<tc::kDC>(dst, a.q, rw, q0, T, D, hd, c * tc::kDC, vw);
        tc::load_tile<tc::kDC>(dst + tc::kTile, a.k, rw, j * tc::kRows, T, D, hd, c * tc::kDC, vw);
      }
    };

    __syncthreads();  // every thread is done with the previous tile's buffers
    if (threadIdx.x == 0) ib[0] = tc::item_base(it, T, D, hd, a.heads);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kNS - 1; ++st) {
      if (st < nsteps) load(st);
      mt::cp_commit();
    }
    float s[8][4], o[16][4], mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f};
    tc::zero(o);
    for (int st = 0; st < nsteps; ++st) {
      if (st + kNS - 1 < nsteps) load(st + kNS - 1);
      mt::cp_commit();
      mt::cp_wait<kNS - 1>();
      __syncthreads();
      int kind, j, c;
      at(st, kind, j, c);
      const bf16* stg = ring + (st % kNS) * kStage;
      bf16* pt = pc + (a.res ? j : 0) * tc::kTile;
      if (kind != kPV) {
        tc::chunk_dots(s, stg, stg + tc::kTile, c);
        if (c == nch - 1) {
          tc::scale_mask(s, r_lo, qc, a.scale, [&](int r, int col) {
            const int kp = j * tc::kRows + col;
            return kp < T && (!causal || kp <= q0 + r);
          });
          if (kind == kStat) {
            tc::row_stats(s, mx, sum);
          } else {
            if (ntk == 1) {  // exact, anew at every fill
              mx[0] = mx[1] = ninf;
              sum[0] = sum[1] = 0.0f;
              tc::row_stats(s, mx, sum);
            }
            tc::fill_p(s, mx, sum, pt, r_lo, qc);
          }
        }
      } else {
        // o += p . v over the key tile, columns [128 c, 128 c + 128)
        mt::wg_fence();
        tc::tile_mul<128>(*reinterpret_cast<float(*)[8][4]>(&o[0][0]), pt, stg, 0, 1);
        tc::tile_mul<128>(*reinterpret_cast<float(*)[8][4]>(&o[8][0]), pt, stg, 64, 1);
        mt::wg_commit();
        mt::wg_wait();
        mt::pin(o);
        if (j == ntk - 1) {
          tc::store_rows<16>(a.out, o, rw, q0, r_lo, qc, c * 128, T, D, hd, a.pairs);
          tc::zero(o);
        }
      }
      __syncthreads();
    }
  }
}

int launch_split_tc(const void* q, const void* k, const void* v, void* out, int N, int T,
                    int heads, int hd, int causal, cudaStream_t stream) {
  const long long items = static_cast<long long>(N) * heads;
  const tc::Plan p = tc::plan(items, T, hd,
                              reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v),
                              reinterpret_cast<uintptr_t>(out));
  const size_t ring = static_cast<size_t>(kNS) * kStage * sizeof(bf16);
  const int cached = tc::cache_tiles(ring, p.tiles, 1);
  const size_t smem = ring + cached * tc::kTileBytes;
  const auto kernel = p.tiles == 1 ? attention_split_one_tc : attention_split_tc;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<bf16*>(out), T, heads * hd, hd, heads, causal,
           static_cast<float>(1.0 / sqrt(static_cast<double>(hd))), items, p.blocks,
           p.lg, p.tiles, p.nch, p.vw, p.pairs, cached == p.tiles};
  kernel<<<static_cast<unsigned>(p.blocks < mt::kMaxGrid ? p.blocks : mt::kMaxGrid), tc::kThreads,
           smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: [N, T, heads * hd] in the compute dtype (kind KIND_F32 or
// KIND_BF16); any hd >= 1 (the route sends hd > 256 here); any T >= 1.
extern "C" int sw_attention_split(const void* q, const void* k, const void* v, void* out, int N,
                                  int T, int heads, int hd, int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || T < 1 || heads < 1 || hd < 1 ||
      static_cast<long long>(heads) * ((hd + kChunk - 1) / kChunk) > 65535 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q, k, v, out, T, heads * hd, hd, heads, 0, causal, 0.0f, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) return launch_split_tc(q, k, v, out, N, T, heads, hd, causal, st);
  return launch_split<float>(a, N, st);
}
