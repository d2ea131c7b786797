// KQ dequant: an int8 dense weight to the compute dtype, qw * scale per slot
// and output channel.
//
// Replaces sitewhere_tpu/models/common.py:265 kernel_weight on an int8 node
// as dense_stacked (:284) reads it in the transformer's stacked forward
// (the projections of mha_stacked :308 and the MLP of
// transformer_block_stacked :329): qw int8[S, I, O] and scale f32[S, 1, O]
// -> [S, I, O] in bf16 or f32, each value wload's (common.cuh) rounding:
// rb(q * rb(scale)), bitwise the reference's qw.astype(dtype) *
// scale.astype(dtype) (|q| <= 127 times a bf16 scale is exact in f32, so
// the one rounding is the product's). The product after it stays a
// torch.bmm, the reference's plain einsum.
//
// Bound on the H100: bytes. At transformer32 a flush dequantizes 25.2 M
// int8 weights into 50.3 MB of bf16 (0.023 ms at 3.35 TB/s). Design: a
// block row per slot (the slot from the grid, no 64-bit index division),
// four weights a thread a step (one 32-bit load of int8 where O is a
// multiple of 4 and the pointer aligned).
#include "common.cuh"

namespace {

// grid (x: a grid-stride loop over one slot's I * O weights, y: the slot);
// offsets within a slot are 32-bit, so no 64-bit division runs
template <bool BF16>
__global__ void dequant_kernel(const int8_t* __restrict__ qw, const float* __restrict__ scale,
                               void* __restrict__ out, int IO, int O, int vec) {
  const long long s = blockIdx.y;
  const int8_t* q = qw + s * IO;
  const float* sc = scale + s * O;
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const long long o0 = s * IO;
  const int stride = gridDim.x * blockDim.x;
  if (vec) {
    const char4* q4 = reinterpret_cast<const char4*>(q);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < (IO >> 2); e += stride) {
      const int i = e << 2;
      const char4 v = q4[e];
      const float* c = sc + i % O;
      store_val(out, kind, o0 + i, wload<WF_I8, BF16>(&v.x, c, 0, 0));
      store_val(out, kind, o0 + i + 1, wload<WF_I8, BF16>(&v.y, c, 0, 1));
      store_val(out, kind, o0 + i + 2, wload<WF_I8, BF16>(&v.z, c, 0, 2));
      store_val(out, kind, o0 + i + 3, wload<WF_I8, BF16>(&v.w, c, 0, 3));
    }
    return;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < IO; i += stride) {
    store_val(out, kind, o0 + i, wload<WF_I8, BF16>(q, sc, i, i % O));
  }
}

}  // namespace

// qw int8[S, I, O], scale f32[S, 1, O] -> out [S, I, O] (kind KIND_F32 or
// KIND_BF16); I * O < 2^31, S <= 65,535.
extern "C" int sw_dequant(const int8_t* qw, const float* scale, void* out, int S, int I, int O,
                          int kind, void* stream) {
  if (S == 0) return static_cast<int>(cudaGetLastError());
  if (S < 0 || S > 65535 || I < 1 || O < 1 || static_cast<long long>(I) * O > 2147483647LL ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int IO = I * O;
  // four at a time where every group of four shares a row of scales and
  // every slot's int8 load is aligned
  const int vec = (O & 3) == 0 && (reinterpret_cast<uintptr_t>(qw) & 3) == 0;
  const int threads = 256;
  const int work = vec ? IO >> 2 : IO;
  const int want = (work + threads - 1) / threads;
  const dim3 grid(want < 264 ? want : 264, S);
  if (kind == KIND_BF16) {
    dequant_kernel<true><<<grid, threads, 0, st>>>(qw, scale, out, IO, O, vec);
  } else {
    dequant_kernel<false><<<grid, threads, 0, st>>>(qw, scale, out, IO, O, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
