// Shared pieces of the bf16 instance of KA's staged form (attention.cu, its
// backward attention_bwd.cu) at head dims 32 and 64: tensor cores
// (mma_tiles.cuh) and the item layout, the paired products and the row
// stores of KA's split form (attention_split.cuh ka_split_tc: Rows,
// item_base, chunk_dots2, store_rows).
//
// A block is kWG warpgroups; each warpgroup takes whole 64-row tiles, so
// every product is a compile-time wgmma: the logits q . k^T (and dp = dout .
// v^T) are m64n64 over hd / 16 k16 steps, p . v (dl . k, p^T . dout, dl^T .
// q) m64n{hd} over the 4 k16 steps of a 64-key tile, p and dl passing on as
// bf16 in wgmma's register A operand (or, where a transpose is needed, as a
// bf16 tile in shared memory).
//   T <= 64, packed: a tile holds every key. Its 64 rows pack 64 >> lg
//     (sequence, head) items of 2^lg rows (2^lg the least power of two >=
//     max(T, 8)) under a block-diagonal mask, as the split form packs them;
//     a block takes kWG tiles of consecutive items (at the transformer's T
//     31, 4 heads: the block's q, k, v are one sequence's contiguous rows),
//     and walks the grid's tiles with the next block's tiles in flight
//     (cp.async into the second of two stages) under the current one's
//     products; its outputs leave through a tile it has read, in 16-byte
//     stores.
//   T > 64, staged: a block per item. Its rows sit in shared memory once
//     (zero past T up to a multiple of 64, so a tile's read stays inside),
//     and the warpgroups take its 64-row query (or key) tiles: wg, 2 kWG -
//     1 - wg, 2 kWG + wg, ... (balanced under the causal mask). Every pass
//     over the keys reads them from shared memory.
// The rounding points are the headers' of attention.cu and attention_bwd.cu:
// the logits rounded to bf16 then scaled by 1/sqrt(hd), f32 exp and sums
// over the full row (the max and sum over all key tiles before p is
// rounded), p = rc(exp(l - max) / sum), dp rounded, dl in XLA's exp / sum
// form; each output accumulated in f32 and rounded once. Past one key tile
// the row's max, sum (and the backward's Sigma term) are taken online over
// the key tiles, so the order of the f32 sums differs from the CUDA-core
// form's (the outputs are held by their float64 error, not bitwise). No
// atomics: two runs are bitwise equal.
#pragma once
#include "attention_split.cuh"
#include "common.cuh"
#include "mma_tiles.cuh"

namespace ka_staged_tc {

using mt::bf16;
namespace sp = ka_split_tc;

constexpr int kRows = 64;                 // a tile's rows: wgmma's M
constexpr int kWG = 2;                    // warpgroups a block
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;                // a packed block's load stages: its next tiles in flight

__host__ __device__ constexpr int pad64(int t) { return (t + 63) & ~63; }
__host__ __device__ constexpr int pad8(int t) { return (t + 7) & ~7; }

// The launch geometry (host side; models/common.py attn_staged_plan mirrors
// it): packed at T <= 64, else staged; blocks of work; each direction's
// dynamic shared memory.
struct Plan {
  int packed;
  int lg;            // log2 of the rows an item takes in a packed tile
  int qtiles;        // 64-row query (and key) tiles an item takes
  long long blocks;  // blocks of work: packed, kWG tiles each; staged, an item each
  size_t fwd_smem;   // two stages of every warpgroup's q, k, v tiles; staged: Q, K, V
  size_t bwd_smem;   // two stages of q, k, v, dout tiles + p^T, dl^T a warpgroup;
                     // staged: V (to a multiple of 8 rows), Q, K, dout, the rows' stats
};

template <int HD>
inline Plan plan(long long items, int T) {
  Plan p{};
  const size_t tile = static_cast<size_t>(kRows) * HD * sizeof(bf16);
  if (T <= kRows) {
    p.packed = 1;
    p.lg = 3;
    while ((1 << p.lg) < T) ++p.lg;
    p.qtiles = 1;
    const long long per = static_cast<long long>(kWG) * (kRows >> p.lg);
    p.blocks = (items + per - 1) / per;
    p.fwd_smem = kStages * 3 * kWG * tile;
    p.bwd_smem = kStages * 4 * kWG * tile +
                 2 * kWG * static_cast<size_t>(kRows) * kRows * sizeof(bf16);
  } else {
    p.packed = 0;
    p.lg = 6;
    p.qtiles = pad64(T) / kRows;
    p.blocks = items;
    p.fwd_smem = 3 * static_cast<size_t>(pad64(T)) * HD * sizeof(bf16);
    p.bwd_smem = static_cast<size_t>(pad8(T) + 3 * pad64(T)) * HD * sizeof(bf16) +
                 static_cast<size_t>(pad64(T)) * sizeof(float4);
  }
  return p;
}

// the grid: a packed kernel's blocks walk the work, as many as are resident
// at once; a staged kernel's a block an item
template <typename K>
inline unsigned grid_of(K kernel, const Plan& p, size_t smem) {
  long long g = p.blocks;
  if (p.packed) {
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem) ==
            cudaSuccess &&
        per > 0 && static_cast<long long>(per) * sms < g)
      g = static_cast<long long>(per) * sms;
  }
  return static_cast<unsigned>(g < mt::kMaxGrid ? g : mt::kMaxGrid);
}

// the warpgroup's named barrier (ids 1.., 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// A packed block's tiles: tile t holds items it0 + t G .. + G - 1 (G = 64
// >> lg), item g's position pos at row (g % G) 2^lg + pos; zero past T and
// past the items. A thread's item and 16-byte column are fixed, so that
// neighbouring threads read neighbouring bytes of a row of [N, T, heads hd]:
// packed_offset is its item's row 0 plus its column in x (-1 past the
// items), the same in every input, and load_packed copies its positions
// (16-byte asynchronous copies; the caller commits).
template <int HD>
__device__ __forceinline__ long long packed_offset(long long it0, long long items, int lg, int T,
                                                   int D, int heads) {
  constexpr int CPR = HD / 8;  // 16-byte pieces of an item's row
  const long long it = it0 + (threadIdx.x / CPR) % (kWG * (kRows >> lg));
  return it < items ? sp::item_base(it, T, D, HD, heads) + (threadIdx.x % CPR) * 8 : -1;
}

template <int HD>
__device__ __forceinline__ void load_packed(bf16* dst, const bf16* __restrict__ x, long long off,
                                            int lg, int T, int D) {
  constexpr int CPR = HD / 8;
  const int G = kRows >> lg, per = CPR * kWG * G;  // per divides kThreads
  const int ch = threadIdx.x % CPR, g = (threadIdx.x / CPR) % (kWG * G);
  bf16* d0 = dst + (g / G) * kRows * HD;
  const int r0 = (g % G) << lg;
  for (int pos = threadIdx.x / per; pos < (1 << lg); pos += kThreads / per) {
    const bool ok = off >= 0 && pos < T;
    mt::cp_async16(d0 + mt::tile_at<HD>(r0 + pos, ch * 8),
                   x + (ok ? off + static_cast<long long>(pos) * D : 0LL), ok ? 16 : 0);
  }
}

// the same element by element, synchronous (x not 16-byte aligned)
template <int HD>
__device__ __forceinline__ void load_packed_elems(bf16* dst, const bf16* __restrict__ x,
                                                  long long it0, long long items, int lg, int T,
                                                  int D, int heads) {
  const int G = kRows >> lg, msk = (1 << lg) - 1;
  for (int e = threadIdx.x; e < kWG * kRows * HD; e += kThreads) {
    const int t = e / (kRows * HD), r = (e / HD) % kRows, d = e % HD;
    const long long it = it0 + t * G + (r >> lg);
    const int pos = r & msk;
    dst[t * kRows * HD + mt::tile_at<HD>(r, d)] =
        it < items && pos < T
            ? x[sp::item_base(it, T, D, HD, heads) + static_cast<long long>(pos) * D + d]
            : __float2bfloat16_rn(0.0f);
  }
}

// the accumulators of a 64 x HD output (rows of the fragment) rounded once
// to bf16 into a tile of HD columns
template <int HD>
__device__ __forceinline__ void frag_to_tile(bf16* tile, const float (&acc)[HD / 8][4], int r_lo,
                                             int qc) {
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + mt::tile_at<HD>(r_lo + 8 * h, 8 * c + qc)) =
          __floats2bfloat162_rn(acc[c][2 * h], acc[c][2 * h + 1]);
}

// A warpgroup's packed output tile (items ib[0..ng), 2^lg rows each) into
// y in 16-byte stores (y 16-byte aligned), neighbouring threads on
// neighbouring bytes of a row of [N, T, heads hd]; positions past T
// skipped. The caller syncs the warpgroup first.
template <int HD>
__device__ __forceinline__ void store_packed(bf16* __restrict__ y, const bf16* tile,
                                             const long long* ib, int ng, int lg, int T, int D) {
  constexpr int CPR = HD / 8;
  const int G = kRows >> lg, per = CPR * G, t = threadIdx.x & 127;  // per divides 128
  const int ch = t % CPR, g = (t / CPR) % G;
  if (g >= ng) return;
  for (int pos = t / per; pos < T; pos += 128 / per)
    *reinterpret_cast<int4*>(y + ib[g] + static_cast<long long>(pos) * D + ch * 8) =
        *reinterpret_cast<const int4*>(tile + mt::tile_at<HD>((g << lg) + pos, ch * 8));
}

// Rows [0, rows) of one item's x (row 0 at base) into a tile of rows x HD;
// zero past T. vec: 16-byte asynchronous copies (the caller commits),
// neighbouring threads on neighbouring bytes of a row; else element by
// element.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ x, long long base,
                                          int rows, int T, int D, bool vec) {
  constexpr int CPR = HD / 8;
  if (vec) {
    for (int e = threadIdx.x; e < rows * CPR; e += kThreads) {
      const int r = e / CPR, ch = e % CPR;
      const bool ok = r < T;
      mt::cp_async16(dst + mt::tile_at<HD>(r, ch * 8),
                     x + (ok ? base + static_cast<long long>(r) * D + ch * 8 : 0LL), ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      dst[mt::tile_at<HD>(r, d)] =
          r < T ? x[base + static_cast<long long>(r) * D + d] : __float2bfloat16_rn(0.0f);
    }
  }
}

// exp(x) in f32 for the softmax's arguments (x = l - max <= 0): 2^(x log2
// e) on the special-function unit (ex2.approx, subnormal results flushed to
// 0), two instructions where expf takes eight; within a few ulps of expf
// (the product x log2 e adds |x| 6e-8 relative), far inside the bf16
// rounding of p and dl that follows
__device__ __forceinline__ float fexp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return r;
}

// The columns each of a thread's two accumulator rows (r_lo, r_lo + 8)
// keeps: [lo, lo + span] of the tile's 64, or none (lo = 64, span = 0).
struct Keep {
  int lo[2];
  int span[2];
};

__device__ __forceinline__ void keep_range(Keep& k, int r, int lo, int hi) {
  k.lo[r] = lo <= hi ? lo : kRows;
  k.span[r] = lo <= hi ? hi - lo : 0;
}

// a packed tile's: the row's item's columns at positions < T (under the
// causal mask, at or before its own)
__device__ __forceinline__ Keep packed_keep(int r_lo, int lg, int T, int causal) {
  Keep k;
  const int msk = (1 << lg) - 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r, lo = row & ~msk;
    keep_range(k, r, lo, lo + (causal ? min(row & msk, T - 1) : T - 1));
  }
  return k;
}

// query rows from row0 (the thread's first), key columns from k0: the keys
// up to the row's last (T - 1; under the causal mask the row itself, or T
// - 1 past it)
__device__ __forceinline__ Keep staged_keep(int row0, int k0, int T, int causal) {
  Keep k;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    keep_range(k, r, 0, (causal ? min(row0 + 8 * r, T - 1) : T - 1) - k0);
  return k;
}

// key rows from key0, query columns from q0: the queries before T (under
// the causal mask, at or after the key); none for a key past T
__device__ __forceinline__ Keep key_keep(int key0, int q0, int T, int causal) {
  Keep k;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    keep_range(k, r, causal ? max(0, key - q0) : 0, key < T ? T - 1 - q0 : -1);
  }
  return k;
}

// the logits of a tile as the reference scales them: s[c8][e] (row r_lo +
// 8 (e >> 1), column 8 c8 + qc + (e & 1)) becomes rc(s) / sqrt(hd) in f32,
// or -inf past the row's kept columns (FULL: the tile keeps every column)
template <bool FULL>
__device__ __forceinline__ void scale_keep(float (&s)[8][4], int qc, float scale, const Keep& k) {
  const float ninf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      mt::rc2(s[c8][e], s[c8][e + 1]);
      const int r = e >> 1;
#pragma unroll
      for (int h = e; h < e + 2; ++h)
        s[c8][h] = FULL || static_cast<unsigned>(8 * c8 + (h & 1) + qc - k.lo[r]) <=
                               static_cast<unsigned>(k.span[r])
                       ? __fmul_rn(s[c8][h], scale)
                       : ninf;
    }
}

__device__ __forceinline__ void scale_keep(float (&s)[8][4], bool full, int qc, float scale,
                                           const Keep& k) {
  if (full)
    scale_keep<true>(s, qc, scale, k);
  else
    scale_keep<false>(s, qc, scale, k);
}

// the max of row r (e = 2 r, 2 r + 1) over the tile, quad-reduced
__device__ __forceinline__ float row_max(const float (&s)[8][4], int r) {
  float tm = -__int_as_float(0x7f800000);
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) tm = fmaxf(tm, fmaxf(s[c8][2 * r], s[c8][2 * r + 1]));
  return mt::quad_max(tm);
}

// The exact softmax statistics of a tile that holds every key: each row's
// max and sum, and e = exp(l - max) in place (a dropped key: 0).
__device__ __forceinline__ void softmax_exact(float (&s)[8][4], float (&mx)[2], float (&sum)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = row_max(s, r);
    float part = 0.0f;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[c8][e] = fexp(__fsub_rn(s[c8][e], mx[r]));
        part = __fadd_rn(part, s[c8][e]);
      }
    sum[r] = mt::quad_sum(part);
  }
}

// each row's max and sum of exp, online over key tiles from (-inf, 0)
__device__ __forceinline__ void row_stats(const float (&s)[8][4], float (&mx)[2],
                                          float (&sum)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float nm = fmaxf(mx[r], row_max(s, r));
    float part = 0.0f;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) part = __fadd_rn(part, fexp(__fsub_rn(s[c8][e], nm)));
    sum[r] = __fadd_rn(__fmul_rn(sum[r], fexp(__fsub_rn(mx[r], nm))), mt::quad_sum(part));
    mx[r] = nm;
  }
}

// the same and ad = sum dp e (dp rounded), for the backward's Sigma term;
// a dropped key (l = -inf) adds nothing
__device__ __forceinline__ void row_stats_dp(const float (&s)[8][4], const float (&dp)[8][4],
                                             float (&mx)[2], float (&sum)[2], float (&ad)[2]) {
  const float ninf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float nm = fmaxf(mx[r], row_max(s, r));
    float part = 0.0f, pa = 0.0f;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float x = fexp(__fsub_rn(s[c8][e], nm));
        part = __fadd_rn(part, x);
        pa = s[c8][e] == ninf ? pa : __fadd_rn(pa, __fmul_rn(dp[c8][e], x));
      }
    const float f = fexp(__fsub_rn(mx[r], nm));
    sum[r] = __fadd_rn(__fmul_rn(sum[r], f), mt::quad_sum(part));
    ad[r] = __fadd_rn(__fmul_rn(ad[r], f), mt::quad_sum(pa));
    mx[r] = nm;
  }
}

// p = rc(exp(l - max) / sum) in place over the tile's scaled logits (a
// dropped key: exp(-inf) = 0, p = 0)
__device__ __forceinline__ void to_p(float (&s)[8][4], const float (&mx)[2], const float (&sum)[2],
                                     const float (&rs)[2]) {
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = e >> 1;
      float p0 = mt::div(fexp(__fsub_rn(s[c8][e], mx[r])), sum[r], rs[r]);
      float p1 = mt::div(fexp(__fsub_rn(s[c8][e + 1], mx[r])), sum[r], rs[r]);
      mt::rc2(p0, p1);
      s[c8][e] = p0;
      s[c8][e + 1] = p1;
    }
}

// p = rc(e / sum) in place from softmax_exact's e
__device__ __forceinline__ void e_to_p(float (&s)[8][4], const float (&sum)[2]) {
  const float rs[2] = {mt::rcp(sum[0]), mt::rcp(sum[1])};
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = e >> 1;
      float p0 = mt::div(s[c8][e], sum[r], rs[r]);
      float p1 = mt::div(s[c8][e + 1], sum[r], rs[r]);
      mt::rc2(p0, p1);
      s[c8][e] = p0;
      s[c8][e + 1] = p1;
    }
}

// dp rounded to bf16 (the reference's dp = dout . v^T rounding point)
__device__ __forceinline__ void round_dp(float (&dp)[8][4]) {
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) {
    mt::rc2(dp[c8][0], dp[c8][1]);
    mt::rc2(dp[c8][2], dp[c8][3]);
  }
}

// dl = ((dp / s) - a) e / sqrt(hd) of a key with e = exp(l - max) (dp
// rounded), before its rounding; 0 where the key is dropped
__device__ __forceinline__ float dl_of(bool kept, float e, float dp, float sum, float rs, float a,
                                       float scale) {
  return kept ? __fmul_rn(__fmul_rn(__fadd_rn(mt::div(dp, sum, rs), -a), e), scale) : 0.0f;
}

// acc (64 x HD) = a . b: a a 64 x 64 bf16 tile in shared memory (K-major:
// rows M, columns the depth), b 64 depth rows of a tile of HD columns used
// MN-major; waits for the result
template <int HD>
__device__ __forceinline__ void smem_mul(float (&acc)[HD / 8][4], const bf16* a, const bf16* b) {
  mt::wg_fence();
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc) {
    if constexpr (HD == 64)
      mt::wg_sst64(&acc[0][0], mt::kdesc<kRows>(a, 0, kc), mt::ndesc<HD>(b, 16 * kc, 0), kc);
    else
      mt::wg_sst32(&acc[0][0], mt::kdesc<kRows>(a, 0, kc), mt::ndesc<HD>(b, 16 * kc, 0), kc);
  }
  mt::wg_commit();
  mt::wg_wait();
  mt::pin(acc);
}

}  // namespace ka_staged_tc
