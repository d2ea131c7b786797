// KA attention: scaled dot-product attention with an f32 softmax, per
// (sequence, head), heads split by column of [N, T, heads * hd] rows.
//
// Replaces sitewhere_tpu/models/common.py:61 attn_core as the transformer
// family's blocks call it (mha_stacked :308, transformer_block_stacked
// :329): q, k, v come in the compute dtype as the projections produce them;
// the QK^T product is accumulated in f32 and rounded to the compute dtype
// (the reference's einsum output), widened to f32 and scaled by
// 1/sqrt(hd) (XLA folds the reference's division into that product);
// causal rows see keys 0..i only (the reference's -1e30 mask gives the
// others exp() = 0); the softmax is exp(l - max) / sum in f32, each p
// rounded to the compute dtype; p.v is accumulated in f32 and rounded once
// into the output. Head dims 32 (the transformer) and 64 (ViT-B/16),
// 1 <= T <= 512 (models/common.py attn_max_t mirrors each instance's shared
// memory and refuses the rest before a launch: f32 at hd 64 takes T <= 435).
//
// Bound on the H100: bytes at the transformer's shapes. One sequence of
// T=31 tokens x 128 columns moves 31.7 KB (q, k, v read, out written) for
// ~0.5 MFLOP, ~15 FLOP a byte, far below the card's ~295 bf16 FLOP a byte.
// Design, bf16 (attention_staged_pack_tc at T <= 64, attention_staged_tc
// past it; attention_staged.cuh): tensor cores, each warpgroup a 64-row
// query tile. At T <= 64 a tile packs 64 >> lg (sequence, head) items under
// a block-diagonal mask and holds every key: one m64n64 product of the
// logits, the exact softmax in registers, p . v from p in the register A
// operand; a block takes two tiles of consecutive items (one sequence's 4
// heads at the transformer's T 31) and loads its next two under the current
// ones' products. Past T 64 a block takes one item, its Q, K and V staged in
// shared memory once, and its two warpgroups share its query tiles: two
// passes over the key tiles (the rows' max and sum, online; then p and p .
// v), both from shared memory.
// Design, f32 (attention_kernel): one block per (sequence, head), four
// warps. K and V of the head
// are staged in shared memory in the input dtype (K rows padded by one
// 32-bit word, so lanes reading one column of 32 different keys hit 32
// banks); a warp takes one query at a time: pass 1, each lane owns keys
// lane, lane+32, ... and writes its logits to the warp's row of shared
// memory, with the row max and the f32 sum of exp reduced by shuffles;
// pass 2, each lane owns hd/32 output columns and accumulates p.v over the
// keys. Two passes, not an online softmax: a running rescale could not
// round p where the reference rounds it.
#include <cmath>

#include "attention_staged.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// round to the compute dtype T
template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

// elements per K row in shared memory: hd plus one 32-bit word
template <typename T, int HD>
__host__ __device__ constexpr int k_stride() {
  return HD + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
size_t smem_bytes(int Tn) {
  const size_t kv = static_cast<size_t>(Tn) * (k_stride<T, HD>() + HD) * sizeof(T);
  const size_t kv_aligned = (kv + 15) / 16 * 16;
  return kv_aligned + static_cast<size_t>(kWarps) * (HD + Tn) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Tn, int D, int causal, float scale) {
  constexpr int KS = k_stride<T, HD>();
  constexpr int HQ = HD / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [Tn][KS]
  T* vs = ks + static_cast<size_t>(Tn) * KS;  // [Tn][HD]
  const size_t kv = static_cast<size_t>(Tn) * (KS + HD) * sizeof(T);
  float* qs = reinterpret_cast<float*>(smem_raw + (kv + 15) / 16 * 16);  // [kWarps][HD]
  float* ps = qs + kWarps * HD;                                          // [kWarps][Tn]

  const long long base = static_cast<long long>(blockIdx.x) * Tn * D + blockIdx.y * HD;
  for (int e = threadIdx.x; e < Tn * HD; e += blockDim.x) {
    const int t = e / HD, d = e % HD;
    ks[t * KS + d] = k[base + static_cast<long long>(t) * D + d];
    vs[t * HD + d] = v[base + static_cast<long long>(t) * D + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qs + warp * HD;
  float* pw = ps + warp * Tn;
  for (int i = warp; i < Tn; i += kWarps) {
    const long long row = base + static_cast<long long>(i) * D;
    for (int d = lane; d < HD; d += 32) qw[d] = to_f(q[row + d]);
    __syncwarp();
    const int nk = causal ? i + 1 : Tn;
    float mx = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < nk; j += 32) {
      const T* kr = ks + j * KS;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qw[d], to_f(kr[d]), acc);
      const float l = __fmul_rn(rc<T>(acc), scale);
      pw[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(__fsub_rn(pw[j], mx));
      pw[j] = e;
      sum = __fadd_rn(sum, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    for (int j = lane; j < nk; j += 32) pw[j] = rc<T>(__fdiv_rn(pw[j], sum));
    __syncwarp();
    float acc[HQ];
#pragma unroll
    for (int c = 0; c < HQ; ++c) acc[c] = 0.0f;
    for (int j = 0; j < nk; ++j) {
      const float p = pw[j];
      const T* vr = vs + j * HD + lane;
#pragma unroll
      for (int c = 0; c < HQ; ++c) acc[c] = fmaf(p, to_f(vr[32 * c]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < HQ; ++c) put(out + row + lane + 32 * c, acc[c]);
    __syncwarp();
  }
}

template <typename T, int HD>
int launch_ka(const void* q, const void* k, const void* v, void* out, int N, int Tn, int heads,
              int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(Tn);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const dim3 grid(N, heads);
  attention_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, heads * HD, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 instance: tensor cores (attention_staged.cuh) -----------------

namespace stc = ka_staged_tc;
namespace sp = ka_split_tc;
using stc::bf16;

struct TcArgs {
  const bf16* q; const bf16* k; const bf16* v; bf16* out;
  int T; int D; int heads; int causal; float scale;
  long long items; long long blocks; int lg; int vec; int pairs; int vout;
};

// T <= 64: each warpgroup one packed tile, the logits q . k^T (m64n64), the
// exact softmax of each row (one key tile), p into the register A operand of
// o = p . v (m64n{HD}), stored once. The block's next tiles load into the
// other stage under this one's products.
template <int HD>
__global__ void __launch_bounds__(stc::kThreads, 2)
attention_staged_pack_tc(const TcArgs a) {
  constexpr int TL = stc::kRows * HD;      // elements of a tile
  constexpr int SZ = 3 * stc::kWG * TL;    // a stage: q, k, v tiles of every warpgroup
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ long long ib[stc::kWG * sp::kMaxItems];
  bf16* ring = reinterpret_cast<bf16*>(smraw);
  const int T = a.T, D = a.D, lg = a.lg;
  const int G = stc::kRows >> lg, ipb = stc::kWG * G;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const stc::Keep keep = stc::packed_keep(r_lo, lg, T, a.causal);
  auto load = [&](long long b, int stage) {
    bf16* dst = ring + stage * SZ;
    const long long it0 = b * ipb;
    const bf16* x[3] = {a.q, a.k, a.v};
    if (a.vec) {
      const long long off = stc::packed_offset<HD>(it0, a.items, lg, T, D, a.heads);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        stc::load_packed<HD>(dst + m * stc::kWG * TL, x[m], off, lg, T, D);
    } else {
#pragma unroll
      for (int m = 0; m < 3; ++m)
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
      float s[8][4], mx[2], sum[2];
      mt::dots<HD, 8>(s, st, st + stc::kWG * TL);
      stc::scale_keep<false>(s, qc, a.scale, keep);
      stc::softmax_exact(s, mx, sum);
      stc::e_to_p(s, sum);
      float o[HD / 8][4];
      sp::zero(o);
      mt::mul_acc<HD, HD / 8, 4>(o, s, st + 2 * stc::kWG * TL, 0);
      if (a.vout) {  // through the q tile (read by now), in 16-byte stores
        stc::frag_to_tile<HD>(st, o, r_lo, qc);
        stc::wg_sync(wg);
        stc::store_packed<HD>(a.out, st, ib + wg * G, ng, lg, T, D);
      } else {
        sp::store_rows<HD / 8>(a.out, o, sp::Rows{ib + wg * G, ng, lg}, 0, r_lo, qc, 0, T, D, HD,
                               a.pairs);
      }
    }
    __syncthreads();
  }
}

// T > 64: a block per item, its Q, K and V staged in shared memory once (V
// arriving under the first pass); each warpgroup takes query tiles and makes
// two passes over the key tiles: each row's max and sum of exp (online),
// then the logits again, p = rc(exp(l - max) / sum) into the register A
// operand of o += p . v, stored once. A causal query tile stops at its own
// key tile.
template <int HD>
__global__ void __launch_bounds__(stc::kThreads, 2) attention_staged_tc(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int T = a.T, D = a.D, causal = a.causal, R = stc::pad64(T), ntq = R / stc::kRows;
  bf16* qs = reinterpret_cast<bf16*>(smraw);
  bf16* ks = qs + R * HD;
  bf16* vs = ks + R * HD;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_lo = warp * 16 + (lane >> 2), qc = (lane & 3) * 2;
  const float ninf = -__int_as_float(0x7f800000);

  for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
    const long long base = sp::item_base(it, T, D, HD, a.heads);
    stc::load_rows<HD>(qs, a.q, base, R, T, D, a.vec);
    stc::load_rows<HD>(ks, a.k, base, R, T, D, a.vec);
    mt::cp_commit();
    stc::load_rows<HD>(vs, a.v, base, R, T, D, a.vec);
    mt::cp_commit();
    mt::cp_wait<1>();
    __syncthreads();
    for (int m = 0;; ++m) {
      const int i = m * stc::kWG + ((m & 1) ? stc::kWG - 1 - wg : wg);
      if (i >= ntq) break;
      const int q0 = i * stc::kRows;
      const int nk = causal ? min(q0 + stc::kRows, T) : T;  // keys the tile's rows see
      const int ntk = (nk + stc::kRows - 1) / stc::kRows;
      // key tile j's logits, scaled and masked
      auto logits = [&](float (&s)[8][4], int j) {
        const int k0 = j * stc::kRows;
        mt::dots<HD, 8>(s, qs + q0 * HD, ks + k0 * HD);
        stc::scale_keep(s, (!causal || j < i) && k0 + stc::kRows <= T, qc, a.scale,
                        stc::staged_keep(q0 + r_lo, k0, T, causal));
      };
      float mx[2] = {ninf, ninf}, sum[2] = {0.0f, 0.0f};
      for (int j = 0; j < ntk; ++j) {
        float s[8][4];
        logits(s, j);
        stc::row_stats(s, mx, sum);
      }
      if (m == 0) {  // every warpgroup has a first tile (T > 64: two tiles at least)
        mt::cp_wait<0>();
        __syncthreads();
      }
      const float rs[2] = {mt::rcp(sum[0]), mt::rcp(sum[1])};
      float o[HD / 8][4];
      sp::zero(o);
      for (int j = 0; j < ntk; ++j) {
        float s[8][4];
        logits(s, j);
        stc::to_p(s, mx, sum, rs);
        mt::mul_acc<HD, HD / 8, 4>(o, s, vs + j * stc::kRows * HD, 0);
      }
      sp::store_rows<HD / 8>(a.out, o, sp::Rows{&base, 1, 6}, q0, r_lo, qc, 0, T, D, HD,
                             a.pairs);
    }
    __syncthreads();  // every warpgroup is done with the item's rows
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int N, int T, int heads,
              int causal, cudaStream_t stream) {
  const long long items = static_cast<long long>(N) * heads;
  const stc::Plan p = stc::plan<HD>(items, T);
  const auto kernel = p.packed ? attention_staged_pack_tc<HD> : attention_staged_tc<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.fwd_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t in = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(out), T, heads * HD, heads, causal,
           static_cast<float>(1.0 / sqrt(static_cast<double>(HD))), items, p.blocks, p.lg,
           (in & 15) == 0, (reinterpret_cast<uintptr_t>(out) & 3) == 0,
           (reinterpret_cast<uintptr_t>(out) & 15) == 0};
  kernel<<<stc::grid_of(kernel, p, p.fwd_smem), stc::kThreads, p.fwd_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: [N, T, heads * hd] in the compute dtype (kind KIND_F32 or
// KIND_BF16); hd 32 or 64; 1 <= T <= 512.
extern "C" int sw_attention(const void* q, const void* k, const void* v, void* out, int N, int T,
                            int heads, int hd, int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || T > 512 || heads < 1 || heads > 65535 || (hd != 32 && hd != 64) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    return hd == 32 ? launch_tc<32>(q, k, v, out, N, T, heads, causal, st)
                    : launch_tc<64>(q, k, v, out, N, T, heads, causal, st);
  }
  return hd == 32 ? launch_ka<float, 32>(q, k, v, out, N, T, heads, causal, st)
                  : launch_ka<float, 64>(q, k, v, out, N, T, heads, causal, st);
}
