// KA, ring step: one step of ring attention, the block's partial attention
// and the running log-sum-exp combine in one launch, in place on the
// running statistics.
//
// Replaces sitewhere_tpu/ops/ring_attention.py:33 _block_attn and the
// combine at :81-86 of ring_attention_local (:50), and on the last step
// the output at :92-93. Per (batch b, head h, query row i) of the rank's
// block, against the arriving key/value block at global offsets q_off
// (the rank's) and k_off (the block's source):
//   s_j  = (q_i . k_j) / sqrt(hd)   (f32; the reference's eager division)
//   s_j  = -1e30 where causal and q_off + i < k_off + j (a finite sentinel)
//   bm   = max_j s_j
//   p_j  = exp(s_j - bm), 0 where masked
//   bl   = sum_j p_j,  bacc = sum_j p_j v_j
//   m'   = max(m, bm);  l' = l e^(m - m') + bl e^(bm - m')
//   acc' = acc e^(m - m') + bacc e^(bm - m')
//   out  = acc' / max(l', 1e-30)  as [B, Tq, H, hd]  (last step only)
// The reference's semantics, not an online softmax inside the block: a
// first pass takes the row max over the block, a second forms p, l and
// acc. A fully masked row keeps bm = -1e30, l = 0, acc = 0 as the
// reference's. Key tiles every row of a query tile masks are not visited:
// their -1e30 still enters the row max, their p is 0. A query tile whose
// rows mask every key leaves m, l, acc as they are (with bm = -1e30 and bl =
// bacc = 0 the combine gives m' = m, l' = l * 1 + 0, acc' = acc * 1 + 0:
// the same bits, save a -0 turning +0), so its arithmetic is skipped; the
// causal ring meets such tiles only after step 0, whose diagonal block
// leaves every row's m finite.
//
// Layouts: q [B, Tq, H, hd], k and v [B, Tk, H, hd], out [B, Tq, H, hd];
// m, l [B, H, Tq], acc [B, H, Tq, hd]; all f32, 1 <= hd <= 256.
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch); the query tile stays in shared memory, key and then value tiles
// of 64 rows stream through one buffer (rows padded to an odd stride, so a
// column read by 16 lanes meets 16 banks). Thread (ty, tx) of 16 x 16 owns
// rows ty + 16 i and keys tx + 16 j (i, j < 4) of a logit tile, and output
// columns tx + 16 c (c < JN, JN 16-column groups cover hd); a row's max
// and sums reduce over the 16 lanes of a half warp by shuffles. Pass 2
// recomputes each logit with pass 1's arithmetic (same bits), writes p to
// shared memory, then accumulates p.v.
//
// Bound on the H100: at main path s's step (B 8, Tl 4,096, H 4, hd 32) the
// function does 4 Tq Tk hd FLOP a (b, h) on a fully visible block, 68.7
// GFLOP, 1.03 ms at the f32 rate of 67 TFLOP/s; it reads q, k, v (12.6
// MB) and reads and writes m, l, acc (4.5 MB each way), 0.007 ms: it is
// bound by operations. This form runs on CUDA cores and computes the
// logits twice (1.5x the FLOP); tensor cores (TF32 would break the f32
// bar; 3xTF32 splits keep it) are the open speed work (PERF.md section 7).
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRows = 64;     // query rows a block
constexpr int kKeys = 64;     // keys a tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int row_stride(int hd) { return hd | 1; }

size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kRows + kKeys) * row_stride(hd) +
                          static_cast<size_t>(kRows) * (kKeys + 1));
}

// a tile of n rows (from row r0 of a [*, H, hd] tensor at head h) into
// shared memory, rows past the tensor's end as zeros
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int n_rows,
                                          int rows, long long rs, int hd) {
  const int hs = row_stride(hd);
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd, c = e - r * hd;
    dst[r * hs + c] = r0 + r < n_rows ? src[static_cast<long long>(r0 + r) * rs + c] : 0.0f;
  }
}

// the 4 x 4 logits of thread (ty, tx): rows ty + 16 i, keys tx + 16 j,
// divided by sqrt(hd) as the reference divides
__device__ __forceinline__ void logits(const float* qs, const float* ks, int hd, float div,
                                       int ty, int tx, float (&s)[4][4]) {
  const int hs = row_stride(hd);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * hs + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * hs + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] / div;
}

// reduce over the 16 lanes of a half warp (tx = lane & 15)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int JN>
__global__ void __launch_bounds__(kThreads)
ring_step_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* m, float* l, float* acc, float* out,
                 int Tq, int Tk, int H, int hd, long long q_off, long long k_off, int causal,
                 float div) {
  extern __shared__ __align__(16) float sm[];
  const int hs = row_stride(hd);
  float* qs = sm;                    // [kRows][hs]
  float* kv = qs + kRows * hs;       // [kKeys][hs]: a key tile, then its value tile
  float* ps = kv + kKeys * hs;       // [kRows][kKeys + 1]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const long long rs = static_cast<long long>(H) * hd;
  const int rows = min(kRows, Tq - q0);
  const long long bh = static_cast<long long>(b) * H + h;
  // the keys any row of the tile sees: the causal mask hides key tiles
  // past the tile's last query position
  const int tiles = (Tk + kKeys - 1) / kKeys;
  int seen = tiles;
  if (causal) {
    const long long last_key = q_off + q0 + rows - 1 - k_off;
    seen = last_key < 0 ? 0 : static_cast<int>(min(static_cast<long long>(tiles),
                                                    last_key / kKeys + 1));
  }
  const bool last = out != nullptr;
  if (seen == 0) {  // every key masked for every row: the state stays as it is
    if (last) {
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const long long row = bh * Tq + q0 + r;
        const float lv = fmaxf(l[row], 1e-30f);
        const long long orow = ((static_cast<long long>(b) * Tq + q0 + r) * H + h) * hd;
        for (int c = tx; c < hd; c += 16) out[orow + c] = acc[row * hd + c] / lv;
      }
    }
    return;
  }
  const float* qb = q + (static_cast<long long>(b) * Tq) * rs + static_cast<long long>(h) * hd;
  const float* kb = k + (static_cast<long long>(b) * Tk) * rs + static_cast<long long>(h) * hd;
  const float* vb = v + (static_cast<long long>(b) * Tk) * rs + static_cast<long long>(h) * hd;
  load_tile(qs, qb, q0, Tq, kRows, rs, hd);

  // pass 1: the row max of the masked logits
  float mx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[i] = -INFINITY;
  for (int t = 0; t < seen; ++t) {
    __syncthreads();
    load_tile(kv, kb, t * kKeys, Tk, kKeys, rs, hd);
    __syncthreads();
    float s[4][4];
    logits(qs, kv, hd, div, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qp = q_off + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * kKeys + tx + 16 * j;
        if (key >= Tk) continue;
        const float x = causal && qp < k_off + key ? kNeg : s[i][j];
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = half_max(mx[i]);
    // a row that masks a key of an unvisited tile: its -1e30 joins the max
    if (causal && k_off + Tk - 1 > q_off + q0 + ty + 16 * i) mx[i] = fmaxf(mx[i], kNeg);
  }

  // pass 2: p, its row sums and p.v
  float ls[4], a[4][JN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < JN; ++c) a[i][c] = 0.0f;
  }
  for (int t = 0; t < seen; ++t) {
    __syncthreads();
    load_tile(kv, kb, t * kKeys, Tk, kKeys, rs, hd);
    __syncthreads();
    float s[4][4];
    logits(qs, kv, hd, div, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qp = q_off + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * kKeys + tx + 16 * j;
        const bool on = key < Tk && !(causal && qp < k_off + key);
        const float p = on ? expf(s[i][j] - mx[i]) : 0.0f;
        ls[i] += p;
        ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = p;
      }
    }
    __syncthreads();  // the key tile is read, p is written
    load_tile(kv, vb, t * kKeys, Tk, kKeys, rs, hd);
    __syncthreads();
    const int nk = min(kKeys, Tk - t * kKeys);
    for (int kk = 0; kk < nk; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kKeys + 1) + kk];
#pragma unroll
      for (int c = 0; c < JN; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = kv[kk * hs + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i][c] = fmaf(pv[i], vv, a[i][c]);
        }
      }
    }
  }

  // the combine with the running statistics, in place; the output on the
  // last step. Every lane of a row reads m and l before lane 0 writes them.
  float mo[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = half_sum(ls[i]);
    const int r = ty + 16 * i;
    mo[i] = r < rows ? m[bh * Tq + q0 + r] : 0.0f;
    lo[i] = r < rows ? l[bh * Tq + q0 + r] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const long long row = bh * Tq + q0 + r;
    const float mn = fmaxf(mo[i], mx[i]);
    const float ro = expf(mo[i] - mn), rk = expf(mx[i] - mn);
    const float ln = lo[i] * ro + ls[i] * rk;
    if (tx == 0) {
      m[row] = mn;
      l[row] = ln;
    }
    const long long orow = ((static_cast<long long>(b) * Tq + q0 + r) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < JN; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        const float an = acc[row * hd + col] * ro + a[i][c] * rk;
        acc[row * hd + col] = an;
        if (last) out[orow + col] = an / fmaxf(ln, 1e-30f);
      }
    }
  }
}

template <int JN>
int launch(const float* q, const float* k, const float* v, float* m, float* l, float* acc,
           float* out, int B, int Tq, int Tk, int H, int hd, long long q_off, long long k_off,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(ring_step_kernel<JN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // sqrt(hd) rounded to f32, the divisor the reference's f32 logits take
  const float div = static_cast<float>(sqrt(static_cast<double>(hd)));
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  ring_step_kernel<JN><<<grid, kThreads, smem, stream>>>(q, k, v, m, l, acc, out, Tq, Tk, H, hd,
                                                         q_off, k_off, causal, div);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Tq, H, hd], k and v [B, Tk, H, hd]; m, l [B, H, Tq] and acc [B, H,
// Tq, hd] updated in place; out [B, Tq, H, hd] written when not NULL (the
// ring's last step). All f32; 1 <= hd <= 256; q_off and k_off the blocks'
// global positions (the causal mask's).
extern "C" int sw_attention_ring(const void* q, const void* k, const void* v, void* m, void* l,
                                 void* acc, void* out, int B, int Tq, int Tk, int H, int hd,
                                 long long q_off, long long k_off, int causal, void* stream) {
  if (B == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  if (B < 0 || B > 65535 || Tq < 0 || Tk < 1 || H < 1 || H > 65535 || hd < 1 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float *mf = static_cast<float*>(m), *lf = static_cast<float*>(l);
  float *af = static_cast<float*>(acc), *of = static_cast<float*>(out);
  if (hd <= 16) return launch<1>(qf, kf, vf, mf, lf, af, of, B, Tq, Tk, H, hd, q_off, k_off, causal, st);
  if (hd <= 32) return launch<2>(qf, kf, vf, mf, lf, af, of, B, Tq, Tk, H, hd, q_off, k_off, causal, st);
  if (hd <= 64) return launch<4>(qf, kf, vf, mf, lf, af, of, B, Tq, Tk, H, hd, q_off, k_off, causal, st);
  if (hd <= 128) return launch<8>(qf, kf, vf, mf, lf, af, of, B, Tq, Tk, H, hd, q_off, k_off, causal, st);
  return launch<16>(qf, kf, vf, mf, lf, af, of, B, Tq, Tk, H, hd, q_off, k_off, causal, st);
}
