// The train form shared by the recurrent families' BPTT kernels, KB
// (lstm_train.cu) and KR (gru_train.cu): the argument struct, the row
// loader (ring mode or windows mode), the saved-activation type, the
// backward's recurrent product dh_{t-1} = dgates . wh^T over a tile, and
// the second, deterministic pass that sums the per-tile partial gradients.
//
// A train launch covers a stacked plane of T slots x B rows; a block owns
// one (slot, 32-row tile). The forward mode writes each row's loss and
// saves, per (step, row), what the backward reads: the gate activations
// (act), the cell state (cst, LSTM only) and the hidden state (hst), in
// the compute dtype (under bf16 compute every saved value is a rounded
// bf16 value of the forward, so the save is exact), and the loss's
// derivative by each head output (dhead, f32). The backward mode takes
// g_row f32[T, B], the seed of the masked per-slot mean, walks the steps in
// reverse, writes the recurrent gate gradients (dgates, compute dtype) for
// the torch.bmm weight gradient dWh[s] = sum_{t,b} h_{t-1}^T dgates_t, and
// sums the other leaves' gradients per tile into partials f32[T, tiles,
// P]; tile_reduce then sums the tiles in a fixed order into reduced
// f32[T, P]. No float atomics: two runs give the same bits.
#pragma once
#include "common.cuh"

constexpr int kTrainRows = 32;     // rows per block (both modes)
constexpr int kBwdThreads = 256;   // backward block: 256 / H row groups x H units

// The backward tile of a train form with G = gates * H gate columns: RG
// row groups of H threads, each thread owning unit u of the PER rows rg +
// RG q (H = 64: 4 groups of 8 rows; H = 8: 32 groups of one row). The
// per-tile partial sums of `red` floats (the row groups' G- and H-wide
// sums) reuse the dgates buffer, which DG sizes for both.
template <int H, int G>
struct BwdTile {
  static constexpr int RG = kBwdThreads / H;
  static constexpr int PER = kTrainRows / RG;
  static_assert(kBwdThreads % H == 0 && kTrainRows % RG == 0, "backward tile shape");
  __host__ __device__ static constexpr int dg(int red) {
    return kTrainRows * G > red ? kTrainRows * G : red;
  }
};

// weight leaves in the family's order (models/train.py TrainForm.leaves)
struct TrainArgs {
  const float* w[8];
  const float* ring; const int* pos; const int* count; int S;
  const float* windows;
  int B; int W;
  float* per_row;
  void* act; void* cst; void* hst; float* dhead;
  const float* g_row; void* dgates; float* partials; float* reduced;
};

template <bool BF16>
__device__ __forceinline__ void save(void* p, long long i, float v) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

template <bool BF16>
__device__ __forceinline__ float saved(const void* p, long long i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

// Row b of slot t into x[0..W), normalized. Windows mode reads
// windows[t, b]; ring mode gathers stream b's window from slot t's ring
// (ops/windows.py gather_windows with ids = arange(S): the ring read from
// pos, a short history left-padded with its oldest value).
__device__ __forceinline__ void train_row_load(const TrainArgs& a, int t, int b, float* x) {
  const int W = a.W;
  if (a.windows != nullptr) {
    const float* src = a.windows + (static_cast<long long>(t) * a.B + b) * W;
    for (int c = 0; c < W; ++c) x[c] = src[c];
  } else {
    const long long s = static_cast<long long>(t) * a.S + b;
    const float* raw = a.ring + s * W;
    const int p = a.pos[s];
    const int cnt = a.count[s];
    const int n = cnt < W ? cnt : W;
    const int fvc = W - n;  // first valid column
    const float first = raw[(p + (fvc < W - 1 ? fvc : W - 1)) % W];
    for (int c = 0; c < W; ++c) x[c] = c < fvc ? first : raw[(p + c) % W];
  }
  float mu, sigma;
  normalize_row(x, W, mu, sigma);
}

// Load the tile's normalized windows into xs[kTrainRows][W] (rows past B
// are zeros); threads 0..31 each load one row.
__device__ __forceinline__ void train_tile_load(const TrainArgs& a, int t, int b0, float* xs) {
  const int r = threadIdx.x;
  if (r < kTrainRows) {
    float* x = xs + r * a.W;
    if (b0 + r < a.B) {
      train_row_load(a, t, b0 + r, x);
    } else {
      for (int c = 0; c < a.W; ++c) x[c] = 0.0f;
    }
  }
}

// The backward of a tile whose rows all carry a zero seed: zero gradients.
// Writes zeros to the tile's dgates rows (G columns, every step) and to
// its P partials.
template <bool BF16>
__device__ void zero_tile(const TrainArgs& a, int t, int tile, int b0, int G, int P) {
  const int steps = a.W - 1;
  const int rows = (a.B - b0) < kTrainRows ? (a.B - b0) : kTrainRows;
  const long long n = static_cast<long long>(steps) * rows * G;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = static_cast<int>(e / (static_cast<long long>(rows) * G));
    const int rem = static_cast<int>(e % (static_cast<long long>(rows) * G));
    const long long row = (static_cast<long long>(t) * steps + s) * a.B + b0 + rem / G;
    save<BF16>(a.dgates, row * G + rem % G, 0.0f);
  }
  float* part = a.partials + (static_cast<long long>(t) * gridDim.x + tile) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) part[p] = 0.0f;
}

// acc[q] += sum_j dG[r][j] * whT[j][u] for the thread's rows r = rg + RG q
// (q < PER) and unit u: dh_{t-1}, the tile's recurrent product with the
// slot's (rounded) recurrent weights, held transposed in shared memory.
template <int H, int G>
__device__ __forceinline__ void recurrent_grad(const float* dG, const float* whT, int rg, int u,
                                               float (&acc)[BwdTile<H, G>::PER]) {
  constexpr int RG = BwdTile<H, G>::RG, PER = BwdTile<H, G>::PER;
#pragma unroll 2
  for (int j = 0; j < G; j += 4) {
    const float w0 = whT[(j + 0) * H + u], w1 = whT[(j + 1) * H + u];
    const float w2 = whT[(j + 2) * H + u], w3 = whT[(j + 3) * H + u];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const float4 d = *reinterpret_cast<const float4*>(dG + (rg + RG * q) * G + j);
      acc[q] = fmaf(d.x, w0, acc[q]);
      acc[q] = fmaf(d.y, w1, acc[q]);
      acc[q] = fmaf(d.z, w2, acc[q]);
      acc[q] = fmaf(d.w, w3, acc[q]);
    }
  }
}

// The second pass: reduced[t][p] = sum over tiles k (in order) of
// partials[t][k][p]. Grid (ceil(P / 128), T), 128 threads.
static __global__ void __launch_bounds__(128) tile_reduce_kernel(const float* part, float* out,
                                                          int tiles, int P) {
  const int t = blockIdx.y;
  const int p = blockIdx.x * 128 + threadIdx.x;
  if (p >= P) return;
  const float* src = part + static_cast<long long>(t) * tiles * P + p;
  float s = 0.0f;
  for (int k = 0; k < tiles; ++k) s += src[static_cast<long long>(k) * P];
  out[static_cast<long long>(t) * P + p] = s;
}

inline int launch_tile_reduce(const TrainArgs& a, int T, int tiles, int P, cudaStream_t st) {
  tile_reduce_kernel<<<dim3((P + 127) / 128, T), 128, 0, st>>>(a.partials, a.reduced, tiles, P);
  return static_cast<int>(cudaGetLastError());
}

// Allow a kernel the dynamic shared memory it is launched with (above
// 48 KB the attribute must be set first).
template <class K>
inline int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}
