// Shared helpers of the scoring-flush kernels: wire dtype loads/stores,
// id loads and the per-row validity rule. Included by every kernel source.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// value / score wire kinds (sitewhere_tpu_torch.kernels callers pass these)
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_F16 = 2 };
// stream-id wire kinds
enum { ID_I32 = 0, ID_U16 = 1 };

__device__ __forceinline__ float load_val(const void* p, int kind, long long i) {
  if (kind == KIND_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (kind == KIND_F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_val(void* p, int kind, long long i, float v) {
  if (kind == KIND_BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else if (kind == KIND_F16) {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ long long load_id(const void* p, int kind, long long i) {
  if (kind == ID_U16) return static_cast<long long>(static_cast<const uint16_t*>(p)[i]);
  return static_cast<long long>(static_cast<const int32_t*>(p)[i]);
}

// A row is valid by its lane count (counts mode: rows fill each lane from
// the front) or by a bool mask (mask mode); exactly one of the two is set.
__device__ __forceinline__ bool row_valid(const int* counts, const unsigned char* mask,
                                          int t, int b, int B) {
  if (mask != nullptr) return mask[static_cast<long long>(t) * B + b] != 0;
  return b < counts[t];
}

// Round a float to bf16 and back (round to nearest even): the rounding
// points of a bf16 computation carried in f32 registers.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
