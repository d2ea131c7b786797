// KT vit_head: the ViT's final LayerNorm on the [CLS] row, the class head,
// the f32 softmax and the top-k, one pass per frame.
// Its train mode (sw_vit_head_train, below) adds the loss and its
// backward.
//
// Replaces what sitewhere_tpu runs after the ViT's last block:
// models/vit.py:92-93 (ln_f, then dense(head, x[:, 0]) cast to f32: apply's
// logits) and the classify dispatch's epilogue,
// services/streaming_media.py:154-155 and :201-202 (jax.nn.softmax, then
// jax.lax.top_k). ln_f runs on the [CLS] row only: LayerNorm is per row, so
// that is what the reference's ln_f over every row gives at row 0. Rounding
// as the reference: f32 statistics (mean = sum / D as XLA multiplies by
// 1/D, var likewise, rsqrt(var + 1e-5)), the affine in f32, the result
// rounded to the compute dtype; each logit an f32-accumulated dot of that
// row with the head column (weights rounded to the compute dtype), rounded,
// plus the rounded bias, rounded, widened to f32; softmax exp(l - max) /
// sum in f32; the top-k by probability, the lower class index first on
// ties (jax.lax.top_k's order; torch.topk's is not defined).
//
// Bound on the H100: bytes. At ViT-B/16's batch of 64 the head reads 3.1
// MB of f32 weights and writes 0.26 MB of logits (~1.0 us at 3.35 TB/s);
// its 98 MFLOP multiply operands rounded to bf16 with f32 accumulation,
// 0.1 us at the tensor cores' 989 TFLOP/s. This kernel does them as f32
// FMAs on the CUDA cores (1.5 us at 67 TFLOP/s), reading the head once
// from device memory, then from L2 by every frame's block. Design: one
// block per frame; the normalized [CLS]
// row lives in shared memory; each thread owns four adjacent classes (one
// 16-byte load a row of the head, coalesced across the warp; classes one
// by one when C is not a multiple of 4), summing over the row; the
// softmax's max and sum and the K rounds of the top-k (a block-wide
// argmax, ties to the lower index, the winner struck out) are block
// reductions by shuffles and shared memory.
//
// Past K = 64 (any K up to C: a top-100 or top-1,000 request) the K argmax
// rounds give way to one sort: each class's key (the probability's bits
// inverted, so a larger probability sorts first, then the class index, so
// a tie puts the lower index first: jax.lax.top_k's order) in 64 bits, the
// C keys padded to a power of two NP with keys that sort last, one bitonic
// sort of NP keys in shared memory (NP = 1,024 at 1,000 classes; in a
// global scratch row a frame when the keys do not fit), and the first K
// read off. Up to K = 64 the argmax rounds are kept, so those outputs stay
// as they were; a top-K past 64 agrees with them on its first 64.
//
// The head's weight is read as stored (the format template WF): f32
// masters rounded to the compute dtype, or a bf16-stored head widened (a
// tree from quantize_params(params, "bf16"): the reference's dense rounds
// an f32 w to the compute dtype, so that tree computes what the f32 tree
// computes in bf16). The LayerNorm and the bias stay f32 in every tree.
#include "common.cuh"
#include "tile_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// block-wide sum (is_max false) or max of one value a thread; every thread
// gets the result
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < kWarps ? red[lane] : (is_max ? -__int_as_float(0x7f800000) : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, u, o);
      u = is_max ? fmaxf(u, w) : __fadd_rn(u, w);
    }
    if (lane == 0) red[kWarps] = u;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

// (v, i) := the better of (v, i) and (v2, i2): the larger value, on a tie
// the lower index
__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// ln_f on frame b's [CLS] row, then the head: z[0..D) ends as ln_f's
// output in the compute dtype; each logit (compute dtype, widened) goes to
// pr[c] in shared memory and to logits[b * C + c]. Returns the largest of
// this thread's logits. Every thread of the block calls it.
template <bool BF16, int WF = WF_F32>
__device__ float cls_logits(const void* __restrict__ x, const float* __restrict__ lnf_s,
                            const float* __restrict__ lnf_b, const void* __restrict__ hwv,
                            const float* __restrict__ hb, float* __restrict__ logits, float* z,
                            float* pr, float* red, long long b, int T, int D, int C) {
  const float inv_d = 1.0f / static_cast<float>(D);

  // ln_f on the [CLS] row
  const long long off = b * T * D;
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = load_val(x, BF16 ? KIND_BF16 : KIND_F32, off + d);
    z[d] = v;
    s = __fadd_rn(s, v);
  }
  const float mean = __fmul_rn(block_reduce(s, red, false), inv_d);
  float sq = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float c = __fsub_rn(z[d], mean);
    z[d] = c;
    sq = __fadd_rn(sq, __fmul_rn(c, c));
  }
  const float r = __frsqrt_rn(__fadd_rn(__fmul_rn(block_reduce(sq, red, false), inv_d), 1e-5f));
  for (int d = threadIdx.x; d < D; d += kThreads)
    z[d] = rb<BF16>(ln_affine(z[d], r, lnf_s[d], lnf_b[d]));
  __syncthreads();

  // the head: logits in the compute dtype, widened to f32. With C a
  // multiple of 4 a thread takes four adjacent classes, its row reads 16
  // bytes wide (more bytes in flight from L2, four independent sums)
  float mx = -__int_as_float(0x7f800000);
  if constexpr (WF == WF_BF16) {
    // a bf16-stored head: already bf16 values, widened
    const __nv_bfloat16* hw = static_cast<const __nv_bfloat16*>(hwv);
    if (C % 4 == 0) {
      const uint2* hw4 = reinterpret_cast<const uint2*>(hw);
      const int C4 = C / 4;
      for (int g = threadIdx.x; g < C4; g += kThreads) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const uint2 w = hw4[static_cast<long long>(d) * C4 + g];
          const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          const float zd = z[d];
          acc[0] = fmaf(zd, w01.x, acc[0]);
          acc[1] = fmaf(zd, w01.y, acc[1]);
          acc[2] = fmaf(zd, w23.x, acc[2]);
          acc[3] = fmaf(zd, w23.y, acc[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * g + j;
          const float l = rb<BF16>(__fadd_rn(rb<BF16>(acc[j]), rb<BF16>(hb[c])));
          logits[b * C + c] = l;
          pr[c] = l;
          mx = fmaxf(mx, l);
        }
      }
    } else {
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float acc = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc = fmaf(z[d], __bfloat162float(hw[static_cast<long long>(d) * C + c]), acc);
        const float l = rb<BF16>(__fadd_rn(rb<BF16>(acc), rb<BF16>(hb[c])));
        logits[b * C + c] = l;
        pr[c] = l;
        mx = fmaxf(mx, l);
      }
    }
    return mx;
  }
  const float* hw = static_cast<const float*>(hwv);
  if (C % 4 == 0) {
    const float4* hw4 = reinterpret_cast<const float4*>(hw);
    const int C4 = C / 4;
    for (int g = threadIdx.x; g < C4; g += kThreads) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 w = hw4[static_cast<long long>(d) * C4 + g];
        const float zd = z[d];
        acc[0] = fmaf(zd, rb<BF16>(w.x), acc[0]);
        acc[1] = fmaf(zd, rb<BF16>(w.y), acc[1]);
        acc[2] = fmaf(zd, rb<BF16>(w.z), acc[2]);
        acc[3] = fmaf(zd, rb<BF16>(w.w), acc[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * g + j;
        const float l = rb<BF16>(__fadd_rn(rb<BF16>(acc[j]), rb<BF16>(hb[c])));
        logits[b * C + c] = l;
        pr[c] = l;
        mx = fmaxf(mx, l);
      }
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        acc = fmaf(z[d], rb<BF16>(hw[static_cast<long long>(d) * C + c]), acc);
      const float l = rb<BF16>(__fadd_rn(rb<BF16>(acc), rb<BF16>(hb[c])));
      logits[b * C + c] = l;
      pr[c] = l;
      mx = fmaxf(mx, l);
    }
  }
  return mx;
}

// The sort path's keys: probability p (>= 0, or NaN) of class c -> a key
// whose ascending order is p descending, then c ascending (a NaN sorts
// first, as torch.sort's descending order puts it); the padding sorts last.
__device__ __forceinline__ unsigned long long topk_key(float p, int c) {
  return (static_cast<unsigned long long>(~__float_as_uint(p)) << 32) |
         static_cast<unsigned int>(c);
}

// Bitonic sort, ascending, of keys[0..np) (np a power of two) by the block.
__device__ void bitonic_sort(unsigned long long* keys, int np) {
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < np; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], c = keys[ixj];
          if ((a > c) == ((i & k) == 0)) {
            keys[i] = c;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// K <= kArgmaxK: K block-wide argmax rounds; past it, the sort
constexpr int kArgmaxK = 64;

template <bool BF16, int WF>
__global__ void __launch_bounds__(kThreads)
vit_head_kernel(const void* __restrict__ x, const float* __restrict__ lnf_s,
                const float* __restrict__ lnf_b, const void* __restrict__ hw,
                const float* __restrict__ hb, float* __restrict__ logits,
                float* __restrict__ probs, int* __restrict__ ids,
                unsigned long long* __restrict__ scratch, int T, int D, int C, int K, int np,
                int keys_off) {
  extern __shared__ float smem[];
  float* z = smem;      // [D] the [CLS] row, then ln_f's output
  float* pr = smem + D;  // [C] logits, then probabilities
  __shared__ float red[kWarps + 1];
  __shared__ int red_i[kWarps];
  const long long b = blockIdx.x;
  float mx = cls_logits<BF16, WF>(x, lnf_s, lnf_b, hw, hb, logits, z, pr, red, b, T, D, C);
  if (K == 0) return;  // uniform across the block
  mx = block_reduce(mx, red, true);

  // softmax in f32
  float se = 0.0f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float e = expf(__fsub_rn(pr[c], mx));
    pr[c] = e;
    se = __fadd_rn(se, e);
  }
  const float sum = block_reduce(se, red, false);
  for (int c = threadIdx.x; c < C; c += kThreads) pr[c] = __fdiv_rn(pr[c], sum);
  __syncthreads();

  if (K > kArgmaxK) {
    // the sort: keys in shared memory past the probabilities (keys_off
    // floats in, 8-byte aligned) or in this frame's scratch row
    unsigned long long* keys =
        scratch != nullptr ? scratch + b * np
                           : reinterpret_cast<unsigned long long*>(smem + keys_off);
    for (int i = threadIdx.x; i < np; i += kThreads)
      keys[i] = i < C ? topk_key(pr[i], i) : ~0ull;
    __syncthreads();
    bitonic_sort(keys, np);
    for (int j = threadIdx.x; j < K; j += kThreads) {
      const unsigned long long key = keys[j];
      probs[b * K + j] = __uint_as_float(~static_cast<unsigned int>(key >> 32));
      ids[b * K + j] = static_cast<int>(key & 0xffffffffu);
    }
    return;
  }

  // top-k: K block-wide argmaxes; a taken class is struck out with -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < K; ++j) {
    float v = -2.0f;
    int i = 0x7fffffff;
    for (int c = threadIdx.x; c < C; c += kThreads) take_better(v, i, pr[c], c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
    if (lane == 0) {
      red[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) take_better(v, i, red[w], red_i[w]);
      probs[b * K + j] = v;
      ids[b * K + j] = i;
      if (i < C) pr[i] = -1.0f;  // i stays past C only if every p is NaN
    }
    __syncthreads();
  }
}

template <bool BF16, int WF>
int launch_kt(const void* x, const float* lnf_s, const float* lnf_b, const void* hw,
              const float* hb, float* logits, float* probs, int* ids,
              unsigned long long* scratch, int B, int T, int D, int C, int K, int np,
              int keys_off, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(vit_head_kernel<BF16, WF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vit_head_kernel<BF16, WF><<<B, kThreads, smem, st>>>(x, lnf_s, lnf_b, hw, hb, logits, probs,
                                                       ids, scratch, T, D, C, K, np, keys_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of sort keys a frame takes at C classes (the next power of two
// at or past C) and whether they fit shared memory beside the frame's D + C
// floats: the wrapper passes a scratch row of np keys a frame when not
// (models/vit.py kt_sort_keys, the same formula).
static int sort_keys(int D, int C, int* fits) {
  int np = 1;
  while (np < C) np <<= 1;
  const size_t base = (static_cast<size_t>(D + C) * sizeof(float) + 7) / 8 * 8;
  *fits = base + static_cast<size_t>(np) * 8 <= 227 * 1024 ? 1 : 0;
  return np;
}

// x: [B, T, D] (kind KIND_F32 or KIND_BF16; row 0 of each frame is read);
// lnf_s, lnf_b f32[D]; hw [D, C] as stored in format wf (WF_F32 or
// WF_BF16); hb f32[C]; logits f32[B, C]; probs f32[B, K] and ids i32[B, K]
// (unused when K is 0); 0 <= K <= C. Past K = 64, scratch: null when the
// sort keys fit shared memory (sort_keys), else u64[B, np].
extern "C" int sw_vit_head(const void* x, const float* lnf_s, const float* lnf_b, const void* hw,
                           int wf, const float* hb, float* logits, float* probs, int* ids,
                           unsigned long long* scratch, int B, int T, int D, int C, int K,
                           int kind, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || D < 1 || C < 1 || K < 0 || K > C || (wf != WF_F32 && wf != WF_BF16) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = static_cast<size_t>(D + C) * sizeof(float);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int np = 0, keys_off = 0;
  if (K > kArgmaxK) {
    int fits = 0;
    np = sort_keys(D, C, &fits);
    if (fits) {
      keys_off = static_cast<int>((smem + 7) / 8 * 8 / sizeof(float));
      smem = static_cast<size_t>(keys_off) * sizeof(float) + static_cast<size_t>(np) * 8;
      scratch = nullptr;
    } else if (scratch == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(kind == KIND_BF16, [&](auto bf) {
    return wf == WF_BF16
               ? launch_kt<decltype(bf)::value, WF_BF16>(x, lnf_s, lnf_b, hw, hb, logits, probs,
                                                         ids, scratch, B, T, D, C, K, np,
                                                         keys_off, smem, st)
               : launch_kt<decltype(bf)::value, WF_F32>(x, lnf_s, lnf_b, hw, hb, logits, probs,
                                                        ids, scratch, B, T, D, C, K, np,
                                                        keys_off, smem, st);
  });
}

// -- train mode ------------------------------------------------------------------
//
// sw_vit_head_train: the loss of models/vit.py:121 (apply, then
// jax.nn.log_softmax of the f32 logits and the mean NLL at the labels) and,
// under jax.grad (:127), its backward down to the final residual stream.
//
// Forward (mode 0), one block a frame: cls_logits (ln_f and the head as in
// serving), then log_softmax in f32 as the reference's jaxpr: m = max,
// j = l - m, s = sum exp(j), logp = j - log(s); the frame's logp at its
// label (a label in [-C, 0) wraps to C + label, as jnp.take_along_axis;
// past the classes it reads NaN, the gather's fill), then one thread sums
// the frames in order: loss = -(sum / B). The f32 logits are written for
// the backward.
//
// Backward (mode 1), from the seed g (f32[1] on the device): per frame, in
// the order of the reference's grad jaxpr, v = (-g) / B scattered at the
// label (dropped past the classes: that frame's cotangent is 0) gives y;
// log_softmax's vjp y + e * (sum(-y) / s), e = exp(l - m) recomputed from
// the saved logits; rounded once to the compute dtype (the transpose of
// the cast to f32): dlogits. d feats = dlogits . w^T (weights rounded to
// the compute dtype, f32 sums, rounded). ln_f's backward on the [CLS] row
// (KL's arithmetic, csrc/layernorm_bwd.cu, with block-wide sums) gives
// row 0 of dh [B, T, D]; its other rows are 0 (the reference's ln_f sees a
// zero cotangent there), written by the same block. Per-frame (c r) dz and
// dz go to partials that tile_sum adds over the frames in order: d
// ln_f.scale and d ln_f.bias, f32. d head.w [D, C] = feats^T . dlogits and
// d head.b [C] = the frame sum of dlogits, each summed over the frames in
// order in f32 and rounded to the compute dtype once (the reference's bf16
// dot and reduction, widened to the f32 params), by a second kernel with
// a thread per (row of d head.w or d head.b, class).
//
// Bound on the H100: bytes. At ViT-B/16's batch of 64 the backward reads
// the head (3.1 MB f32), the logits and the [CLS] rows (0.36 MB) and writes
// d head.w (3.1 MB) and dh (19.4 MB in bf16, all but 64 rows zeros): ~7.5
// us at 3.35 TB/s; its 2 x 49 MFLOP of products are 0.1 us at the tensor
// cores' rate. Design: one block per frame for the row work (dlogits in
// shared memory; d feats with a warp per column of w^T, its lanes over the
// classes, coalesced; ln_f's sums by block reductions); one thread per
// output element for the head's gradients (classes across the threads:
// coalesced reads of dlogits and writes of d head.w). No float atomics:
// two runs give the same bits.

namespace {

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
vit_head_train_fwd(const void* __restrict__ x, const float* __restrict__ lnf_s,
                   const float* __restrict__ lnf_b, const float* __restrict__ hw,
                   const float* __restrict__ hb, const int* __restrict__ labels,
                   float* __restrict__ logits, float* __restrict__ lp, int T, int D, int C) {
  extern __shared__ float smem[];
  float* z = smem;       // [D] ln_f's output
  float* pr = smem + D;  // [C] logits
  __shared__ float red[kWarps + 1];
  const long long b = blockIdx.x;
  float mx = cls_logits<BF16>(x, lnf_s, lnf_b, hw, hb, logits, z, pr, red, b, T, D, C);
  mx = block_reduce(mx, red, true);
  float se = 0.0f;
  for (int c = threadIdx.x; c < C; c += kThreads) se = __fadd_rn(se, expf(__fsub_rn(pr[c], mx)));
  const float s = block_reduce(se, red, false);
  if (threadIdx.x == 0) {
    int lab = labels[b];
    if (lab < 0) lab += C;
    lp[b] = lab >= 0 && lab < C ? __fsub_rn(__fsub_rn(pr[lab], mx), logf(s))
                                : __int_as_float(0x7fc00000);
  }
}

// loss = -(sum of the frames' logp at their labels, in order) / B
__global__ void vit_head_train_mean(const float* __restrict__ lp, float* __restrict__ loss,
                                    int B) {
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s = __fadd_rn(s, lp[b]);
  loss[0] = -__fdiv_rn(s, static_cast<float>(B));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
vit_head_train_bwd_rows(const void* __restrict__ x, const float* __restrict__ lnf_s,
                        const float* __restrict__ lnf_b, const float* __restrict__ hw,
                        const int* __restrict__ labels, const float* __restrict__ logits,
                        const float* __restrict__ g, void* __restrict__ dh,
                        float* __restrict__ feats, float* __restrict__ dlog,
                        float* __restrict__ part, int T, int D, int C) {
  extern __shared__ float smem[];
  float* cz = smem;          // [D] the centered [CLS] row
  float* dz = smem + D;      // [D] d feats, rounded
  float* dl = smem + 2 * D;  // [C] e, then dlogits (rounded)
  __shared__ float red[kWarps + 1];
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x;
  const int B = gridDim.x;
  const float inv_d = 1.0f / static_cast<float>(D);
  const float two_d = 2.0f / static_cast<float>(D);

  // ln_f's statistics on the [CLS] row, as the forward computes them
  const long long off = b * T * D;
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = load_val(x, kind, off + d);
    cz[d] = v;
    s = __fadd_rn(s, v);
  }
  const float mean = __fmul_rn(block_reduce(s, red, false), inv_d);
  float sq = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float c = __fsub_rn(cz[d], mean);
    cz[d] = c;
    sq = __fadd_rn(sq, __fmul_rn(c, c));
  }
  const float ve = __fadd_rn(__fmul_rn(block_reduce(sq, red, false), inv_d), 1e-5f);
  const float r = __frsqrt_rn(ve);
  for (int d = threadIdx.x; d < D; d += kThreads)
    feats[b * D + d] = rb<BF16>(ln_affine(cz[d], r, lnf_s[d], lnf_b[d]));

  // dlogits
  const float* lrow = logits + b * C;
  float mx = -__int_as_float(0x7f800000);
  for (int c = threadIdx.x; c < C; c += kThreads) mx = fmaxf(mx, lrow[c]);
  mx = block_reduce(mx, red, true);
  float se = 0.0f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float e = expf(__fsub_rn(lrow[c], mx));
    dl[c] = e;
    se = __fadd_rn(se, e);
  }
  const float sum = block_reduce(se, red, false);
  int lab = labels[b];
  if (lab < 0) lab += C;
  const bool hit = lab >= 0 && lab < C;
  const float v = __fdiv_rn(-g[0], static_cast<float>(B));
  const float q = __fdiv_rn(hit ? -v : -0.0f, sum);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float y = hit && c == lab ? v : 0.0f;
    const float d = rb<BF16>(__fadd_rn(y, __fmul_rn(dl[c], q)));
    dl[c] = d;
    dlog[b * C + c] = d;
  }
  __syncthreads();

  // d feats = dlogits . w^T: a warp per column d, its lanes over the classes
  for (int d = warp; d < D; d += kWarps) {
    const float* wr = hw + static_cast<long long>(d) * C;
    float acc = 0.0f;
    for (int c = lane; c < C; c += 32) acc = fmaf(dl[c], rb<BF16>(wr[c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) dz[d] = rb<BF16>(acc);
  }
  __syncthreads();

  // ln_f's backward on the [CLS] row (layernorm_bwd.cu's arithmetic)
  float dr = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads)
    dr = __fadd_rn(dr, __fmul_rn(cz[d], __fmul_rn(dz[d], lnf_s[d])));
  dr = block_reduce(dr, red, false);
  const float dvar = __fmul_rn(dr, __fmul_rn(__fdiv_rn(r, ve), -0.5f));
  const float qv = __fmul_rn(dvar, two_d);
  float s1 = 0.0f, s2 = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    s1 = __fadd_rn(s1, __fmul_rn(__fmul_rn(dz[d], lnf_s[d]), r));
    s2 = __fadd_rn(s2, __fmul_rn(cz[d], qv));
  }
  s1 = block_reduce(s1, red, false);
  s2 = block_reduce(s2, red, false);
  const float dmean = __fmul_rn(__fadd_rn(-s1, -s2), inv_d);
  float* pp = part + b * 2 * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float dcd = __fmul_rn(__fmul_rn(dz[d], lnf_s[d]), r);
    const float t2 = __fmul_rn(cz[d], qv);
    store_val(dh, kind, off + d, __fadd_rn(__fadd_rn(dcd, t2), dmean));
    pp[d] = __fmul_rn(__fmul_rn(cz[d], r), dz[d]);
    pp[D + d] = dz[d];
  }
  // the other rows' cotangent is 0
  const long long n = static_cast<long long>(T) * D;
  for (long long i = D + threadIdx.x; i < n; i += kThreads) store_val(dh, kind, off + i, 0.0f);
}

// d head.w [D, C] (rows 0..D-1) and d head.b [C] (row D): grid (ceil(C /
// kThreads), D + 1), a thread per class
__global__ void __launch_bounds__(kThreads)
vit_head_train_bwd_w(const float* __restrict__ feats, const float* __restrict__ dlog,
                     float* __restrict__ dhw, float* __restrict__ dhb, int B, int D, int C,
                     int to_bf16) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int d = blockIdx.y;
  if (c >= C) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float f = d < D ? feats[static_cast<long long>(b) * D + d] : 1.0f;
    acc = fmaf(f, dlog[static_cast<long long>(b) * C + c], acc);
  }
  const float v = to_bf16 ? round_bf16(acc) : acc;
  if (d < D) {
    dhw[static_cast<long long>(d) * C + c] = v;
  } else {
    dhb[c] = v;
  }
}

template <bool BF16>
int launch_kt_train(int mode, const void* x, const float* lnf_s, const float* lnf_b,
                    const float* hw, const float* hb, const int* labels, float* logits, float* lp,
                    float* loss, const float* g, void* dh, float* feats, float* dlog, float* part,
                    float* red, float* dhw, float* dhb, int B, int T, int D, int C,
                    cudaStream_t st) {
  cudaError_t err;
  if (mode == 0) {
    const size_t smem = static_cast<size_t>(D + C) * sizeof(float);
    err = cudaFuncSetAttribute(vit_head_train_fwd<BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    vit_head_train_fwd<BF16><<<B, kThreads, smem, st>>>(x, lnf_s, lnf_b, hw, hb, labels, logits,
                                                        lp, T, D, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    vit_head_train_mean<<<1, 1, 0, st>>>(lp, loss, B);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(2 * D + C) * sizeof(float);
  err = cudaFuncSetAttribute(vit_head_train_bwd_rows<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vit_head_train_bwd_rows<BF16><<<B, kThreads, smem, st>>>(x, lnf_s, lnf_b, hw, labels, logits, g,
                                                           dh, feats, dlog, part, T, D, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vit_head_train_bwd_w<<<dim3((C + kThreads - 1) / kThreads, D + 1), kThreads, 0, st>>>(
      feats, dlog, dhw, dhb, B, D, C, BF16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tile_sum(part, red, 1, B, 2 * D, 0, st);
}

}  // namespace

// mode 0 (forward): x [B, T, D] (kind), lnf_s, lnf_b f32[D], hw f32[D, C],
// hb f32[C], labels i32[B] -> logits f32[B, C], lp f32[B] (each frame's
// logp at its label), loss f32[1]. mode 1 (backward): also g f32[1] (the
// loss's cotangent) and the forward's logits -> dh [B, T, D] (kind), d
// head.w dhw f32[D, C], d head.b dhb f32[C], red f32[2 D] = [d ln_f.scale |
// d ln_f.bias]; feats f32[B, D], dlog f32[B, C] and part f32[B, 2 D] are
// scratch. Unused pointers may be null.
extern "C" int sw_vit_head_train(int mode, const void* x, const float* lnf_s, const float* lnf_b,
                                 const float* hw, const float* hb, const int* labels,
                                 float* logits, float* lp, float* loss, const float* g, void* dh,
                                 float* feats, float* dlog, float* part, float* red, float* dhw,
                                 float* dhb, int B, int T, int D, int C, int kind, void* stream) {
  if (B < 1 || T < 1 || D < 1 || C < 1 || D + 1 > 65535 || (mode != 0 && mode != 1) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(2 * D + C) * sizeof(float) > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16
             ? launch_kt_train<true>(mode, x, lnf_s, lnf_b, hw, hb, labels, logits, lp, loss, g,
                                     dh, feats, dlog, part, red, dhw, dhb, B, T, D, C, st)
             : launch_kt_train<false>(mode, x, lnf_s, lnf_b, hw, hb, labels, logits, lp, loss, g,
                                      dh, feats, dlog, part, red, dhw, dhb, B, T, D, C, st);
}
