// Shared pieces of the attention kernels (flash_attention.cu, gqa_decode.cu):
// the online-softmax sentinels, bf16/f32 conversion, and a tile copy from
// device memory into float32 shared memory with 16-byte loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

// The JAX reference's sentinels: masked scores are kNeg, and the running
// maximum is floored at kSafe before it is subtracted, so a fully masked
// tile adds exp(kNeg - kSafe) = 0 and never NaN.
constexpr float kNeg = -1e30f;
constexpr float kSafe = -1e20f;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kElems = 4;  // floats in 16 bytes
  __device__ __forceinline__ static void unpack(const uint4& r, float* d) {
    d[0] = __uint_as_float(r.x);
    d[1] = __uint_as_float(r.y);
    d[2] = __uint_as_float(r.z);
    d[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static float to_f32(float x) { return x; }
  __device__ __forceinline__ static float from_f32(float x) { return x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kElems = 8;  // bf16 values in 16 bytes
  __device__ __forceinline__ static void unpack(const uint4& r, float* d) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16(x);
  }
};

// Copy rows [0, n_rows) of one or two [ROWS, HD] tiles of T (row r at
// src + r * stride elements; src 16-byte aligned) into float32 shared
// memory (row r at dst + r * ld), writing zeros to rows n_rows..ROWS-1 so
// that padded keys and values stay finite. All NT threads of the block
// take part; each keeps up to kChunk 16-byte loads of each tile in flight
// before it converts and stores them.
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tiles(float* dst_a, int ld_a,
                                           const T* __restrict__ src_a,
                                           float* dst_b, int ld_b,
                                           const T* __restrict__ src_b,
                                           int64_t stride, int n_rows) {
  constexpr int kE = Pack<T>::kElems;
  constexpr int kVecPerRow = HD / kE;
  constexpr int kTotal = ROWS * kVecPerRow;
  constexpr int kChunk = 8;
  for (int base = 0; base < kTotal; base += NT * kChunk) {
    uint4 ra[kChunk], rb[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int e = base + static_cast<int>(threadIdx.x) + i * NT;
      const int r = e / kVecPerRow;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      rb[i] = ra[i];
      if (e < kTotal && r < n_rows) {
        const int64_t off = r * stride + (e % kVecPerRow) * kE;
        ra[i] = __ldg(reinterpret_cast<const uint4*>(src_a + off));
        if (src_b != nullptr)
          rb[i] = __ldg(reinterpret_cast<const uint4*>(src_b + off));
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int e = base + static_cast<int>(threadIdx.x) + i * NT;
      if (e >= kTotal) continue;
      const int r = e / kVecPerRow, c = (e % kVecPerRow) * kE;
      float f[kE];
      Pack<T>::unpack(ra[i], f);
#pragma unroll
      for (int u = 0; u < kE; ++u) dst_a[r * ld_a + c + u] = f[u];
      if (dst_b != nullptr) {
        Pack<T>::unpack(rb[i], f);
#pragma unroll
        for (int u = 0; u < kE; ++u) dst_b[r * ld_b + c + u] = f[u];
      }
    }
  }
}

// Let a kernel use more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_shared_bytes(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
