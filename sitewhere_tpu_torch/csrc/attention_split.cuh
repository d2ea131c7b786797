// Shared pieces of KA's split form (attention_split.cu, its backward
// attention_split_bwd.cu): attention at head dims past the tiled form's 256.
//
// f32 (namespace ka_split), CUDA cores: the tiled form (attention_tiled.cu)
// gives each lane hd/32 output columns of each of its warp's 16/(hd/32)
// query rows: 16 accumulators a lane, so hd 256 is the widest head it holds
// (past hd 512 a warp would hold no row at all). The split form cuts the
// output columns into chunks of kChunk (256) and gives each chunk its own
// block; every block computes the logits q.k^T (and in the backward dp =
// dout.v^T) over the FULL head dim, streaming q, k (v, dout) through shared
// memory kChunk columns at a time and continuing one f32 sum, d ascending:
// every chunk's block forms the same bits of p, and the sum is the one the
// tiled form's row_dots would form at that hd. A block then accumulates p.v
// (the backward dq, dk, dv) for its own columns only. No atomics: two runs
// are bitwise equal.
//
// bf16 (namespace ka_split_tc), tensor cores (mma_tiles.cuh): a block is one
// warpgroup and one 64-row query (or key) tile with ALL of its output
// columns. The head dim streams through a ring of shared-memory stages in
// 64-column chunks (cp.async, 16, 8 or 4 bytes a copy as the row pitch
// allows, element by element otherwise; zero past T and past hd), so every
// product has a compile-time shape (m64n64k16) and any hd runs on the same
// code. The logits (and dp) accumulate over the chunks in wgmma's f32
// registers; the rounded p (and dl) go to shared memory as bf16 tiles, the
// A operand of the products that follow, which stream the B operand (v, k,
// q, dout) a column chunk at a time and store each output chunk once.
// Sequences of T <= 32 pack 2..8 to a tile under a block-diagonal mask.
#pragma once
#include "common.cuh"
#include "mma_tiles.cuh"

namespace ka_split {

constexpr int kWarps = 4;
constexpr int kTile = 32;            // keys (or queries) a streamed tile: one a lane
constexpr int kChunk = 256;          // columns a chunk
constexpr int kHQ = kChunk / 32;     // own columns a lane
constexpr int kRW = 2;               // rows (keys) a warp: kRW x kHQ = 16 accumulators
constexpr int kBR = kWarps * kRW;    // rows (keys) a block
constexpr int kRS = kChunk + 4;      // padded stride of a streamed tile's rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Columns [c0, c0 + kChunk) of rows [r0, r0 + n) of x (rows at or past
// `valid` and columns at or past hd are 0; with `clamp` a row past `valid`
// repeats row valid - 1 instead) into dst, n rows of stride `stride`.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* __restrict__ x, long long base,
                                           int r0, int n, int valid, bool clamp, int c0, int hd,
                                           int stride, int D) {
  for (int e = threadIdx.x; e < n * kChunk; e += blockDim.x) {
    const int r = e / kChunk, d = e - r * kChunk;
    int j = r0 + r;
    bool ok = j < valid;
    if (clamp && !ok) {
      j = valid - 1;
      ok = true;
    }
    dst[r * stride + d] =
        (ok && c0 + d < hd) ? to_f(x[base + static_cast<long long>(j) * D + c0 + d]) : 0.0f;
  }
}

// l[r] += a_r . b over w4 columns (a multiple of 4; the padding is 0): kRW
// rows a (stride sa, shared by the warp) against the lane's row b, d
// ascending. Continued over the chunks it is the tiled form's row_dots.
__device__ __forceinline__ void dots_acc(const float* a, int sa, const float* b, int w4,
                                         float (&l)[kRW]) {
  for (int d = 0; d < w4; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(a + r * sa + d);
      l[r] = fmaf(av.x, bv.x, l[r]);
      l[r] = fmaf(av.y, bv.y, l[r]);
      l[r] = fmaf(av.z, bv.z, l[r]);
      l[r] = fmaf(av.w, bv.w, l[r]);
    }
  }
}

// Columns of the chunk from c0 that exist (hd - c0, at most kChunk),
// rounded up to 4.
__device__ __forceinline__ int chunk_w4(int c0, int hd) {
  const int w = min(kChunk, hd - c0);
  return (w + 3) & ~3;
}

}  // namespace ka_split

namespace ka_split_tc {

using mt::bf16;

constexpr int kThreads = 128;       // one warpgroup a block
constexpr int kRows = 64;           // rows of every tile: wgmma's M, a query or key tile
constexpr int kDC = 64;             // columns of a depth chunk
constexpr int kTile = kRows * kDC;  // elements of a 64 x 64 tile (8 KB)
constexpr int kMaxItems = 8;        // (sequence, head) items a tile packs (T <= 8)
constexpr size_t kSmemMax = 232448;
constexpr size_t kTileBytes = kTile * sizeof(bf16);

// Where a block's tile rows live: row r is position p0 + (r & (2^lg - 1)) of
// item r >> lg, whose row 0 is at ib[r >> lg] (lg = 6: one item, 64 rows
// from p0; lg < 6: 64 >> lg items of 2^lg rows from p0 = 0).
struct Rows {
  const long long* ib;
  int ng;  // items of the block that exist
  int lg;
};

// element offset of position 0 of item `it` ((sequence, head)) in
// [N, T, heads * hd]
__device__ __forceinline__ long long item_base(long long it, int T, int D, int hd, int heads) {
  return (it / heads) * T * static_cast<long long>(D) + (it % heads) * static_cast<long long>(hd);
}

// Tile rows [0, 64) (positions from p0) x columns [c0, c0 + W) of the
// head into a tile of W columns; zero past T, past hd and past the block's
// items. vw bytes a copy: 16, 8 or 4 asynchronous (2 hd a multiple of vw,
// the tensors vw-aligned; a zero fill reads nothing; the caller commits),
// 2 element by element, synchronous.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ x, const Rows& rw,
                                          int p0, int T, int D, int hd, int c0, int vw) {
  const int msk = (1 << rw.lg) - 1;
  if (vw >= 4) {
    const int lp = vw == 16 ? 0 : vw == 8 ? 1 : 2;  // log2 copies an 8-column core row
    const int n = (kRows * W / 8) << lp;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int part = e & ((1 << lp) - 1), e2 = e >> lp;
      // eight neighbouring lanes (or parts of them) fill one core matrix
      const int ch = (e2 >> 3) % (W / 8), r = (e2 / W) * 8 + (e2 & 7);
      const int d = ch * 8 + (part << (3 - lp));
      const int g = r >> rw.lg, pos = p0 + (r & msk);
      const bool ok = g < rw.ng && pos < T && c0 + d < hd;
      const bf16* src = ok ? x + rw.ib[g] + static_cast<long long>(pos) * D + c0 + d : x;
      bf16* sd = dst + mt::tile_at<W>(r, d);
      if (lp == 0)
        mt::cp_async16(sd, src, ok ? 16 : 0);
      else if (lp == 1)
        mt::cp_async8(sd, src, ok ? 8 : 0);
      else
        mt::cp_async4(sd, src, ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
      const int r = e / W, d = e % W;
      const int g = r >> rw.lg, pos = p0 + (r & msk);
      const bool ok = g < rw.ng && pos < T && c0 + d < hd;
      dst[mt::tile_at<W>(r, d)] =
          ok ? x[rw.ib[g] + static_cast<long long>(pos) * D + c0 + d] : __float2bfloat16_rn(0.0f);
    }
  }
}

// acc (64 x 64) = a . b^T (+ acc when `more`) over one W-column chunk of
// two tiles used K-major; waits for the result
template <int W = kDC>
__device__ __forceinline__ void chunk_dots(float (&acc)[8][4], const bf16* a, const bf16* b,
                                           int more) {
  mt::wg_fence();
#pragma unroll
  for (int kc = 0; kc < W / 16; ++kc)
    mt::wg_ss64(&acc[0][0], mt::kdesc<W>(a, 0, kc), mt::kdesc<W>(b, 0, kc), more | kc);
  mt::wg_commit();
  mt::wg_wait();
  mt::pin(acc);
}

// both products of a chunk, a . b^T and c . d^T, issued together
template <int W = kDC>
__device__ __forceinline__ void chunk_dots2(float (&x)[8][4], float (&y)[8][4], const bf16* a,
                                            const bf16* b, const bf16* c, const bf16* d,
                                            int more) {
  mt::wg_fence();
#pragma unroll
  for (int kc = 0; kc < W / 16; ++kc) {
    mt::wg_ss64(&x[0][0], mt::kdesc<W>(a, 0, kc), mt::kdesc<W>(b, 0, kc), more | kc);
    mt::wg_ss64(&y[0][0], mt::kdesc<W>(c, 0, kc), mt::kdesc<W>(d, 0, kc), more | kc);
  }
  mt::wg_commit();
  mt::wg_wait();
  mt::pin(x);
  mt::pin(y);
}

// acc (64 x 64) = a . b (+ acc when `more`): a a 64 x 64 bf16 tile of the
// products' A operand (rows M, columns the depth: p, dl or their
// transposes), b columns [n0, n0 + 64) of a tile of W columns used
// MN-major (rows the depth). Issues only: the caller commits and waits.
template <int W>
__device__ __forceinline__ void tile_mul(float (&acc)[8][4], const bf16* a, const bf16* b, int n0,
                                         int more) {
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc)
    mt::wg_sst64(&acc[0][0], mt::kdesc<kDC>(a, 0, kc), mt::ndesc<W>(b, 16 * kc, n0), more | kc);
}

// The logits of a 64 x 64 tile as the reference scales them: s[c8][e]
// (row r_lo + 8 (e >> 1), column 8 c8 + qc + (e & 1)) becomes rc(s) /
// sqrt(hd) in f32, or -inf where keep(row, column) is false.
template <typename Keep>
__device__ __forceinline__ void scale_mask(float (&s)[8][4], int r_lo, int qc, float scale,
                                           Keep keep) {
  const float ninf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      mt::rc2(s[c8][e], s[c8][e + 1]);
#pragma unroll
      for (int h = e; h < e + 2; ++h)
        s[c8][h] = keep(r_lo + 4 * e, 8 * c8 + qc + (h & 1)) ? __fmul_rn(s[c8][h], scale) : ninf;
    }
}

// each of the thread's two rows' max and sum of exp, continued online from
// (mx, sum) over the tile's scaled logits (a dropped key adds exp(-inf) =
// 0); from (-inf, 0) over the only tile, exact
__device__ __forceinline__ void row_stats(const float (&s)[8][4], float (&mx)[2],
                                          float (&sum)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tm = -__int_as_float(0x7f800000);
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) tm = fmaxf(tm, fmaxf(s[c8][2 * r], s[c8][2 * r + 1]));
    const float nm = fmaxf(mx[r], mt::quad_max(tm));
    float part = 0.0f;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) part = __fadd_rn(part, expf(__fsub_rn(s[c8][e], nm)));
    sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), mt::quad_sum(part));
    mx[r] = nm;
  }
}

// p = rc(exp(l - max) / sum) of the tile's scaled logits into the bf16
// tile pt (rows of the fragment; a dropped key gives exp(-inf) = 0), made
// visible to wgmma
__device__ __forceinline__ void fill_p(const float (&s)[8][4], const float (&mx)[2],
                                       const float (&sum)[2], bf16* pt, int r_lo, int qc);

// two values of an accumulator row into a bf16 tile (natural layout, rows
// of the fragment; col even)
__device__ __forceinline__ void put2(bf16* tile, int r, int col, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(tile + mt::tile_at<kDC>(r, col)) =
      __floats2bfloat162_rn(x, y);
}

// the output chunk's accumulators (columns [c0, c0 + 8 C)) rounded once
// into rows r_lo and r_lo + 8 of the block's items (rows past T or past
// the items skipped); pairs: 4-byte stores (hd even, the tensor aligned)
template <int C>
__device__ __forceinline__ void store_rows(bf16* __restrict__ y, const float (&acc)[C][4],
                                           const Rows& rw, int p0, int r_lo, int qc, int c0,
                                           int T, int D, int hd, int pairs) {
  const int msk = (1 << rw.lg) - 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h, g = r >> rw.lg, pos = p0 + (r & msk);
    if (g >= rw.ng || pos >= T) continue;
    bf16* row = y + rw.ib[g] + static_cast<long long>(pos) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c0 + 8 * c + qc;
      if (col >= hd) continue;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[c][2 * h], acc[c][2 * h + 1]);
      } else {
        row[col] = __float2bfloat16_rn(acc[c][2 * h]);
        if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(acc[c][2 * h + 1]);
      }
    }
  }
}

__device__ __forceinline__ void fill_p(const float (&s)[8][4], const float (&mx)[2],
                                       const float (&sum)[2], bf16* pt, int r_lo, int qc) {
  const float rs[2] = {mt::rcp(sum[0]), mt::rcp(sum[1])};
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = e >> 1;
      float p0 = mt::div(expf(__fsub_rn(s[c8][e], mx[r])), sum[r], rs[r]);
      float p1 = mt::div(expf(__fsub_rn(s[c8][e + 1], mx[r])), sum[r], rs[r]);
      mt::rc2(p0, p1);
      put2(pt, r_lo + 4 * e, 8 * c8 + qc, p0, p1);
    }
  mt::fence_async();
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[C][4]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
}

// The launch geometry of every bf16 split kernel (the host side;
// models/common.py attn_split_plan mirrors it). T <= 64: one tile of 64
// rows packs 64 >> lg items of 2^lg rows (2^lg the least power of two >=
// max(T, 8)); past it one item a tile (lg 6), `tiles` tiles an item.
struct Plan {
  int lg;
  int tiles;         // query (or key) tiles an item
  long long blocks;  // blocks of the grid's work
  int nch;           // 64-column chunks of the head dim
  int vw;            // bytes a copy (16, 8, 4; 2: element by element)
  int pairs;         // the outputs take 4-byte stores
};

inline Plan plan(long long items, int T, int hd, uintptr_t in_addr, uintptr_t out_addr) {
  Plan p{};
  if (T <= kRows) {
    p.lg = 3;
    while ((1 << p.lg) < T) ++p.lg;
    p.tiles = 1;
    const int per = kRows >> p.lg;
    p.blocks = (items + per - 1) / per;
  } else {
    p.lg = 6;
    p.tiles = (T + kRows - 1) / kRows;
    p.blocks = items * p.tiles;
  }
  p.nch = (hd + kDC - 1) / kDC;
  p.vw = 16;
  while (p.vw > 2 && ((2 * hd) % p.vw != 0 || (in_addr & (p.vw - 1)) != 0)) p.vw >>= 1;
  p.pairs = hd % 2 == 0 && (out_addr & 3) == 0;
  return p;
}

// the cache tiles that fit beside `fixed` bytes: every one of `need`, or 1
inline int cache_tiles(size_t fixed, int need, int per_tile) {
  return fixed + static_cast<size_t>(need) * per_tile * kTileBytes <= kSmemMax ? need : 1;
}

}  // namespace ka_split_tc
