// KJ dct_patches: the compressed media wire's on-device half in one pass,
// truncated zigzag DCT coefficients -> the ViT's input patches.
//
// Replaces sitewhere_tpu/ops/dct.py:176 decode_frames (idct_plane :128,
// upsample2x :160, ycbcr_to_rgb :166) with the normalization of
// models/vit.py:116-117 apply_dct, patchify (:75) and the cast to the
// compute dtype in dense (models/common.py:32). Math as the reference, in
// f32: the coefficients dezigzagged into natural order (zero past k), the
// 8x8 IDCT X = M^T C M (M the orthonormal DCT-II basis, as idct_basis) +
// 128; with 4:2:0 the chroma planes upsampled by the libjpeg "fancy"
// triangle filter, rows first (0.75 cur + 0.25 neighbour), the neighbour
// clamped at the edge of the PADDED chroma plane, not the crop; JFIF BT.601
// YCbCr -> RGB clamped to 0..255; then (rgb / 255 - 0.5) / 0.5 op by op,
// patchified ([B, N, P*P*3], element (r * P + c) * 3 + channel) and rounded
// to the compute dtype. Optionally the f32 RGB frame itself (a check of the
// decode).
//
// Bound on the H100: bytes. At ViT-B/16's 224x224 4:2:0 frames a frame
// reads 2 k (784 + 2 * 196) bytes of coefficients and writes 196 x 768
// bf16 patch values (301 KB); the IDCT is ~16 MACs a pixel. Design: one
// block per (frame, output patch). It stages the coefficient blocks its
// patch needs in shared memory: the (P/8)^2 luma blocks and, per chroma
// plane, the blocks under the patch with the triangle filter's one-pixel
// halo (at most (P/16 + 2)^2 with 4:2:0); runs the separable IDCT on them
// there (a pass over rows, a pass over columns); then each thread makes the
// RGB of its output pixels from shared memory and writes their normalized
// values. Neighbouring patches recompute the halo's chroma blocks; that
// costs arithmetic the card has to spare, never bytes.
#include "common.cuh"

namespace {

// the orthonormal 8-point DCT-II basis M[u][x] (ops/dct.py idct_basis, its
// float32 values)
__constant__ float kM[64] = {
    0.3535533845424652f, 0.3535533845424652f, 0.3535533845424652f, 0.3535533845424652f,
    0.3535533845424652f, 0.3535533845424652f, 0.3535533845424652f, 0.3535533845424652f,
    0.49039262533187866f, 0.41573479771614075f, 0.27778512239456177f, 0.09754516184329987f,
    -0.09754516184329987f, -0.27778512239456177f, -0.41573479771614075f, -0.49039262533187866f,
    0.4619397521018982f, 0.19134171307086945f, -0.19134171307086945f, -0.4619397521018982f,
    -0.4619397521018982f, -0.19134171307086945f, 0.19134171307086945f, 0.4619397521018982f,
    0.41573479771614075f, -0.09754516184329987f, -0.49039262533187866f, -0.27778512239456177f,
    0.27778512239456177f, 0.49039262533187866f, 0.09754516184329987f, -0.41573479771614075f,
    0.3535533845424652f, -0.3535533845424652f, -0.3535533845424652f, 0.3535533845424652f,
    0.3535533845424652f, -0.3535533845424652f, -0.3535533845424652f, 0.3535533845424652f,
    0.27778512239456177f, -0.49039262533187866f, 0.09754516184329987f, 0.41573479771614075f,
    -0.41573479771614075f, -0.09754516184329987f, 0.49039262533187866f, -0.27778512239456177f,
    0.19134171307086945f, -0.4619397521018982f, 0.4619397521018982f, -0.19134171307086945f,
    -0.19134171307086945f, 0.4619397521018982f, -0.4619397521018982f, 0.19134171307086945f,
    0.09754516184329987f, -0.27778512239456177f, 0.41573479771614075f, -0.49039262533187866f,
    0.49039262533187866f, -0.41573479771614075f, 0.27778512239456177f, -0.09754516184329987f,
};

// natural (row-major) position in an 8x8 block -> its zigzag index (the
// inverse of ops/dct.py ZIGZAG)
__constant__ int kUnzig[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
};

constexpr int kThreads = 256;

struct KjArgs {
  const int16_t* y; const int16_t* cb; const int16_t* cr;
  void* out; float* rgb;
  int W; int H; int y_gw; int y_gh; int c_gw; int c_gh; int sub; int k;
};

// chroma blocks a side of the staged region: the patch's blocks plus the
// triangle filter's halo (4:2:0), or the patch's own blocks (4:4:4)
template <int P>
__host__ __device__ constexpr int chroma_side() {
  return (P / 16 + 2) > (P / 8) ? (P / 16 + 2) : (P / 8);
}

// a*x + b*y with each product and the sum rounded (the reference's
// 0.75 * x + 0.25 * neighbour as three f32 ops)
__device__ __forceinline__ float tri(float x, float nb) {
  return __fadd_rn(__fmul_rn(0.75f, x), __fmul_rn(0.25f, nb));
}

template <int P, bool BF16>
__global__ void __launch_bounds__(kThreads)
dct_patches_kernel(const KjArgs a) {
  constexpr int LB = P / 8;             // luma blocks a side
  constexpr int CB = chroma_side<P>();  // chroma blocks a side (room)
  constexpr int NS = LB * LB + 2 * CB * CB;
  __shared__ float coef[NS][64];  // natural-order coefficients, then pixels
  __shared__ float tmp[NS][64];   // M^T C
  // the tables, read with a different address in every lane: from shared
  // memory (constant memory serializes such reads)
  __shared__ float m[64];
  __shared__ int unzig[64];
  if (threadIdx.x < 64) {
    m[threadIdx.x] = kM[threadIdx.x];
    unzig[threadIdx.x] = kUnzig[threadIdx.x];
  }
  __syncthreads();

  const int gw = a.W / P;
  const int n_patches = (a.H / P) * gw;
  const long long b = blockIdx.x / n_patches;
  const int n = blockIdx.x - static_cast<int>(b * n_patches);
  const int Y0 = (n / gw) * P, X0 = (n % gw) * P;
  const int ch = a.c_gh * 8, cw = a.c_gw * 8;  // padded chroma plane
  // staged chroma block rows / columns
  int br0, br1, bc0, bc1;
  if (a.sub == 2) {
    br0 = max(Y0 / 2 - 1, 0) / 8;
    br1 = min((Y0 + P - 1) / 2 + 1, ch - 1) / 8;
    bc0 = max(X0 / 2 - 1, 0) / 8;
    bc1 = min((X0 + P - 1) / 2 + 1, cw - 1) / 8;
  } else {
    br0 = Y0 / 8; br1 = (Y0 + P - 1) / 8;
    bc0 = X0 / 8; bc1 = (X0 + P - 1) / 8;
  }
  const int nr = br1 - br0 + 1, nc = bc1 - bc0 + 1;

  // slot s -> its coefficient block in global memory (nullptr: unused)
  auto block_src = [&](int s) -> const int16_t* {
    if (s < LB * LB) {
      const int gi = (Y0 / 8 + s / LB) * a.y_gw + X0 / 8 + s % LB;
      return a.y + (b * a.y_gw * a.y_gh + gi) * a.k;
    }
    const int q = (s - LB * LB) / (CB * CB), l = (s - LB * LB) % (CB * CB);
    const int i = l / CB, j = l % CB;
    if (i >= nr || j >= nc) return nullptr;
    const int gi = (br0 + i) * a.c_gw + bc0 + j;
    return (q == 0 ? a.cb : a.cr) + (b * a.c_gw * a.c_gh + gi) * a.k;
  };

  // 1. dezigzag into natural order, zero past k
  for (int e = threadIdx.x; e < NS * 64; e += kThreads) {
    const int s = e >> 6, pos = e & 63;
    const int16_t* src = block_src(s);
    const int z = unzig[pos];
    coef[s][pos] = (src != nullptr && z < a.k) ? static_cast<float>(src[z]) : 0.0f;
  }
  __syncthreads();
  // 2. T[x][v] = sum_u M[u][x] C[u][v]
  for (int e = threadIdx.x; e < NS * 64; e += kThreads) {
    const int s = e >> 6, x = (e >> 3) & 7, v = e & 7;
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = fmaf(m[u * 8 + x], coef[s][u * 8 + v], acc);
    tmp[s][x * 8 + v] = acc;
  }
  __syncthreads();
  // 3. pixel[x][y] = sum_v T[x][v] M[v][y] + 128 (into coef's room)
  for (int e = threadIdx.x; e < NS * 64; e += kThreads) {
    const int s = e >> 6, x = (e >> 3) & 7, y = e & 7;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < 8; ++v) acc = fmaf(tmp[s][x * 8 + v], m[v * 8 + y], acc);
    coef[s][x * 8 + y] = __fadd_rn(acc, 128.0f);
  }
  __syncthreads();

  // chroma plane q's pixel at padded-plane coordinates (ci, cj)
  auto chroma = [&](int q, int ci, int cj) -> float {
    const int s = LB * LB + q * CB * CB + (ci / 8 - br0) * CB + (cj / 8 - bc0);
    return coef[s][(ci & 7) * 8 + (cj & 7)];
  };
  // 4. each output pixel: RGB, normalization, patch layout
  const long long out_base = static_cast<long long>(blockIdx.x) * P * P * 3;
  for (int e = threadIdx.x; e < P * P; e += kThreads) {
    const int r = e / P, c = e % P;
    const int Y = Y0 + r, X = X0 + c;
    const float yv = coef[(r / 8) * LB + c / 8][(r & 7) * 8 + (c & 7)];
    float cv[2];
    for (int q = 0; q < 2; ++q) {
      if (a.sub == 2) {
        const int i0 = Y >> 1, j0 = X >> 1;
        const int in = (Y & 1) ? min(i0 + 1, ch - 1) : max(i0 - 1, 0);
        const int jn = (X & 1) ? min(j0 + 1, cw - 1) : max(j0 - 1, 0);
        const float r0 = tri(chroma(q, i0, j0), chroma(q, in, j0));
        const float rn = tri(chroma(q, i0, jn), chroma(q, in, jn));
        cv[q] = tri(r0, rn);
      } else {
        cv[q] = chroma(q, Y, X);
      }
    }
    const float cbv = __fsub_rn(cv[0], 128.0f), crv = __fsub_rn(cv[1], 128.0f);
    float rgb[3];
    rgb[0] = __fadd_rn(yv, __fmul_rn(1.402f, crv));
    rgb[1] = __fsub_rn(__fsub_rn(yv, __fmul_rn(0.344136f, cbv)), __fmul_rn(0.714136f, crv));
    rgb[2] = __fadd_rn(yv, __fmul_rn(1.772f, cbv));
#pragma unroll
    for (int ch3 = 0; ch3 < 3; ++ch3) {
      const float v = fminf(fmaxf(rgb[ch3], 0.0f), 255.0f);
      if (a.rgb != nullptr)
        a.rgb[((b * a.H + Y) * a.W + X) * 3 + ch3] = v;
      const float norm = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), 0.5f), 0.5f);
      store_val(a.out, BF16 ? KIND_BF16 : KIND_F32, out_base + e * 3 + ch3, norm);
    }
  }
}

template <int P>
int launch_kj(const KjArgs& a, int B, int bf16, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(B) * (a.H / P) * (a.W / P);
  if (bf16) {
    dct_patches_kernel<P, true><<<grid, kThreads, 0, st>>>(a);
  } else {
    dct_patches_kernel<P, false><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: i16[B, y_gh * y_gw, k]; cb, cr: i16[B, c_gh * c_gw, k]; out: [B, (H/P)
// * (W/P), P * P * 3] (f32, or bf16 with bf16 != 0); rgb: f32[B, H, W, 3] or
// NULL. sub 1 (c grid = y grid) or 2 (y grid = 2 x c grid); P 8 or 16,
// dividing H and W; 1 <= k <= 64.
extern "C" int sw_dct_patches(const int16_t* y, const int16_t* cb, const int16_t* cr, void* out,
                              float* rgb, int B, int W, int H, int y_gw, int y_gh, int c_gw,
                              int c_gh, int sub, int k, int P, int bf16, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if ((sub != 1 && sub != 2) || k < 1 || k > 64 || y_gw != sub * c_gw || y_gh != sub * c_gh ||
      W < 1 || H < 1 || W > 8 * y_gw || H > 8 * y_gh || W % P || H % P)
    return static_cast<int>(cudaErrorInvalidValue);
  const KjArgs a{y, cb, cr, out, rgb, W, H, y_gw, y_gh, c_gw, c_gh, sub, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 8: return launch_kj<8>(a, B, bf16, st);
    case 16: return launch_kj<16>(a, B, bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
