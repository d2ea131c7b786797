// The wide train form shared by KB's and KR's wide kernels
// (lstm_train_wide.cu, gru_train_wide.cu): any hidden H and any window, for
// the shapes the templated train forms (lstm_train.cu, gru_train.cu) do
// not take. Those hold a thread's H-float column of wh in registers, the
// tile's normalized windows in shared memory and, in the backward, wh^T
// [G][H] in shared memory: at H 128 the LSTM's is 128 x 512 x 4 B = 256 KB,
// more than a block has. Here, as in the wide serving forms
// (scan_wide.cuh), H is a runtime value and nothing H x G or W long sits in
// shared memory:
//
// - a block takes R rows (32, 16 or 8: the most whose state fits,
//   models/flush.py train_route; the global form's rule is global_rows);
//   an item is (unit u, group of kTR = 8
//   rows), a thread takes items tid, tid + nthreads, ... in the same order
//   in every step and phase, so what an item owns (its rows' c, dc, dh
//   and its row group's partial sums) needs no exchange;
// - forward: h transposed and double-buffered, hT[2][H][R + 4], wh
//   streamed from L1/L2 (wide::item_dots), the heads a warp per row; one
//   barrier a step;
// - backward: the step's dgates transposed, dGT[G][R + 4] (the item
//   writes its G / H columns for its 8 rows as float4s), and dh_{t-1} =
//   dgates . wh^T with wh^T read from wt, a transposed copy of the slots'
//   wh at the compute dtype that a small kernel writes first
//   (wh_transpose), so that a warp's 32 units read 32 neighbouring floats;
//   two barriers a step;
// - windows are read from global memory (wide::RowSrc: the row's mean and
//   sigma in the prologue, each step's normalized value when needed; ring
//   mode gathers stream b of the slot with gather_windows' left-pad rule).
//
// The saves are the templated forms' own, in their layouts (bptt.cuh), so
// models/train.py reads either form's the same way. No float atomics: each
// row group's sums are its item's, the tile's partial is their sum in row
// group order, and tile_reduce sums the tiles in order.
//
// The block state (forward: hT, the LSTM's c, the heads' weights;
// backward: dGT, dh, the LSTM's dc, the row groups' partial sums, the
// heads' weights) sits in shared memory in the wide form, which caps the
// hidden width (the backward's: 784 for KB, 1,017 for KR at 8 rows), or,
// in the global form (GS = true: sw_lstm_train_global,
// sw_gru_train_global), in the block's slice of a global scratch that
// models/train.py train_buffers allocates, one per mode: the same kernels
// (scan_wide.cuh block_state, in_waves). Shared memory keeps only the
// rows' sources and per-row scalars. The per-row results, the saves and
// dgates do not depend on R; the leaves' sums do, through the order in
// which tiles of R rows are summed (tile_partials, tile_reduce).
#pragma once
#include "bptt.cuh"
#include "scan_wide.cuh"

namespace bw {

using wide::kTR;

// Row b of slot t's window source in TrainArgs's two modes, with its
// statistics (train_row_load's values, without holding the window).
__device__ __forceinline__ wide::RowSrc train_src(const TrainArgs& a, int t, int b) {
  const int W = a.W;
  wide::RowSrc src;
  if (a.windows != nullptr) {
    src.base = a.windows + (static_cast<long long>(t) * a.B + b) * W;
    src.p = 0;
    src.fvc = 0;
    src.first = 0.0f;
  } else {
    const long long s = static_cast<long long>(t) * a.S + b;
    src.base = a.ring + s * W;
    src.p = a.pos[s];
    const int cnt = a.count[s];
    const int n = cnt < W ? cnt : W;
    src.fvc = W - n;  // first valid column
    src.first = src.base[(src.p + (src.fvc < W - 1 ? src.fvc : W - 1)) % W];
  }
  wide::row_stats(src, W);
  return src;
}

// The block's row sources (threads 0 .. R-1; rows past B are zeros).
__device__ __forceinline__ void load_srcs(const TrainArgs& a, int t, int b0, int R,
                                          wide::RowSrc* srcs) {
  const int r = threadIdx.x;
  if (r < R) srcs[r] = b0 + r < a.B ? train_src(a, t, b0 + r) : wide::pad_row(a.W);
}

// wt[t][j][k] = rb(wh[t][k][j]): the slots' wh^T at the compute dtype,
// through a 32 x 32 shared tile. Grid (ceil(G / 32), ceil(H / 32), T),
// 32 x 8 threads.
template <bool BF16>
__global__ void __launch_bounds__(256) wh_transpose(const float* wh, float* wt, int H, int G) {
  __shared__ float tile[32][33];
  const long long base = static_cast<long long>(blockIdx.z) * H * G;
  const int j0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, j = j0 + threadIdx.x;
    if (k < H && j < G) tile[i][threadIdx.x] = rb<BF16>(wh[base + static_cast<long long>(k) * G + j]);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int j = j0 + i, k = k0 + threadIdx.x;
    if (j < G && k < H) wt[base + static_cast<long long>(j) * H + k] = tile[threadIdx.x][i];
  }
}

template <bool BF16>
inline int launch_transpose(const float* wh, float* wt, int T, int H, int G, cudaStream_t st) {
  wh_transpose<BF16><<<dim3((G + 31) / 32, (H + 31) / 32, T), dim3(32, 8), 0, st>>>(wh, wt, H, G);
  return static_cast<int>(cudaGetLastError());
}

// A wide train launch's grid: H, R, the row tiles of a slot, this wave's
// first block, and the global form's scratch (floats a block).
struct Grid {
  int H; int R; int tiles; long long blk0;
  float* state; long long stride;
};

// The block's slot and row tile.
__device__ __forceinline__ void block_tile(const Grid& g, int& t, int& tile) {
  const long long blk = g.blk0 + blockIdx.x;
  t = static_cast<int>(blk / g.tiles);
  tile = static_cast<int>(blk % g.tiles);
}

// The backward of a tile whose rows all carry a zero seed: zeros to its
// rows' dgates (G columns, every step) and to its P partials (zero_tile at
// R rows a tile, `tiles` tiles a slot).
template <bool BF16>
__device__ void zero_rows(const TrainArgs& a, int t, int tile, int tiles, int b0, int R, int G,
                          int P) {
  const int steps = a.W - 1;
  const int rows = (a.B - b0) < R ? (a.B - b0) : R;
  const long long per = static_cast<long long>(rows) * G;
  const long long n = static_cast<long long>(steps) * per;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = static_cast<int>(e / per);
    const int rem = static_cast<int>(e % per);
    const long long row = (static_cast<long long>(t) * steps + s) * a.B + b0 + rem / G;
    save<BF16>(a.dgates, row * G + rem % G, 0.0f);
  }
  float* part = a.partials + (static_cast<long long>(t) * tiles + tile) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) part[p] = 0.0f;
}

// Whether any row of the tile carries a non-zero seed (every thread gets
// the answer; a barrier).
__device__ __forceinline__ bool tile_live(const TrainArgs& a, int t, int b0, int R) {
  bool live = false;
  const int r = threadIdx.x;
  if (r < R && b0 + r < a.B) live = a.g_row[static_cast<long long>(t) * a.B + b0 + r] != 0.0f;
  return __syncthreads_or(live);
}

// Store an item's kTR values of one column into a transposed buffer row
// (two float4s: the rows r0 .. r0 + 7 of column c, row stride RS).
__device__ __forceinline__ void put_rows(float* buf, int c, int RS, int r0, const float (&v)[kTR]) {
  float4* dst = reinterpret_cast<float4*>(buf + static_cast<long long>(c) * RS + r0);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[r] += sum_j dGT[j][r0 + r] * wt[j][u] over the G columns in order:
// an item's share of dh_{t-1} = dgates . wh^T (wtu: the slot's wt offset to
// unit u, row stride H).
__device__ __forceinline__ void item_rgrad(float (&acc)[kTR], const float* dGT, int RS, int r0,
                                           const float* wtu, int H, int G) {
  for (int j = 0; j < G; ++j) {
    const float4 d0 = *reinterpret_cast<const float4*>(dGT + j * RS + r0);
    const float4 d1 = *reinterpret_cast<const float4*>(dGT + j * RS + r0 + 4);
    const float w = wtu[static_cast<long long>(j) * H];
    acc[0] = fmaf(d0.x, w, acc[0]);
    acc[1] = fmaf(d0.y, w, acc[1]);
    acc[2] = fmaf(d0.z, w, acc[2]);
    acc[3] = fmaf(d0.w, w, acc[3]);
    acc[4] = fmaf(d1.x, w, acc[4]);
    acc[5] = fmaf(d1.y, w, acc[5]);
    acc[6] = fmaf(d1.z, w, acc[6]);
    acc[7] = fmaf(d1.w, w, acc[7]);
  }
}

// The tile's partial sums: part[p] = sum over row groups (in order) of
// acc[rg][p], p < PA (the block's threads).
__device__ __forceinline__ void tile_partials(const float* acc, int RG, int PA, float* part) {
  for (int p = threadIdx.x; p < PA; p += blockDim.x) {
    float s = 0.0f;
    for (int g = 0; g < RG; ++g) s += acc[g * PA + p];
    part[p] = s;
  }
}

// Floats of the wide train forms' block state (models/flush.py
// train_state_floats mirrors them): NG gate columns a unit, NH heads, cell
// state or not, PA a row group's partial sums. Forward: hT [2][H][RS], c
// [R][H], the heads [NH][H]. Backward: dGT [G][RS], dh [R][H], dc [R][H],
// the row groups' sums [R / kTR][PA], the heads [NH][H].
inline long long fwd_state(int H, int R, bool cell, int NH) {
  return 2LL * H * (R + 4) + (cell ? static_cast<long long>(R) * H : 0) +
         static_cast<long long>(NH) * H;
}

inline long long bwd_state(int H, int R, bool cell, int NH, int NG, int PA) {
  const long long G = static_cast<long long>(NG) * H;
  return G * (R + 4) + static_cast<long long>(R) * H * (cell ? 2 : 1) +
         static_cast<long long>(R / kTR) * PA + static_cast<long long>(NH) * H;
}

// Bytes of shared memory beside the state: the rows' sources, and per row
// the forward's two steps' x and loss, the backward's two steps' seeds (NH
// a step) and x. The wide form adds the state (models/flush.py
// train_wide_smem_bytes).
inline size_t fwd_small(int R) { return R * sizeof(wide::RowSrc) + 3 * R * sizeof(float); }

inline size_t bwd_small(int R, int NH) {
  return R * sizeof(wide::RowSrc) + (2 * R * NH + 2 * R) * sizeof(float);
}

// Launch a train kernel over the plane's T x tiles blocks: one wave (the
// wide form) or waves of at most `wave` blocks over the scratch (GS).
template <bool GS, class Kern>
inline int launch_grid(Kern kernel, Grid g, int T, int threads, size_t smem, long long wave,
                       cudaStream_t st, const TrainArgs& a, const float* wt) {
  const int err = wide::prepare<GS>(kernel, smem);
  if (err != 0) return err;
  const long long blocks = static_cast<long long>(g.tiles) * T;
  return wide::in_waves(blocks, GS ? wave : blocks, [&](long long blk0, unsigned n) {
    g.blk0 = blk0;
    kernel<<<n, threads, smem, st>>>(a, g, wt);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace bw
