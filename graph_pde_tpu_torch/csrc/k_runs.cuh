// Reading the cached kernel matrices K in 8-element runs: the loaders
// shared by the K-streaming kernels (fused_iterate.cu, K2;
// fused_iterate_bwd.cu, B2-bwd; cached_contraction.cu, B3).
//
// A run is 8 consecutive K elements of one row, 16-byte aligned: 32 bytes
// of fp32, 16 of bf16, 8 of fp8 (e4m3 or e5m2, the 1-byte K stream of
// k_storage). Every K type is upcast to fp32 exactly: bf16 by a 16-bit
// shift, fp8 pairwise through the packed fp8x2 -> f16x2 convert (every
// fp8 value is exact in fp16).
//
// RawRun<KT>::type holds a run's raw bytes, so that a kernel can keep
// many runs in flight in few registers and convert each at its multiply;
// ::ldg reads one through the read-only cache.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct RunF32 {
  float4 a, b;
};

template <typename KT>
struct RawRun;

template <>
struct RawRun<float> {
  using type = RunF32;
  static __device__ __forceinline__ type ldg(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
};

template <>
struct RawRun<__nv_bfloat16> {
  using type = uint4;
  static __device__ __forceinline__ type ldg(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
};

template <typename F8>
struct RawRunFp8 {
  using type = uint2;
  static __device__ __forceinline__ type ldg(const F8* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
};

template <>
struct RawRun<__nv_fp8_e4m3> : RawRunFp8<__nv_fp8_e4m3> {};
template <>
struct RawRun<__nv_fp8_e5m2> : RawRunFp8<__nv_fp8_e5m2> {};

template <__nv_fp8_interpretation_t KIND>
__device__ __forceinline__ void fp8x4_to_float(uint32_t w, float* v) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> (16 * h)), KIND);
    const float2 f = __half22float2(__half2(r));
    v[2 * h] = f.x;
    v[2 * h + 1] = f.y;
  }
}

// v = the run's 8 values in fp32.
template <typename KT>
__device__ __forceinline__ void unpack_run(const typename RawRun<KT>::type& r,
                                           float (&v)[8]) {
  if constexpr (std::is_same<KT, float>::value) {
    v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
    v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
  } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // bf16 -> fp32 is a 16-bit left shift of the bit pattern
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        std::is_same<KT, __nv_fp8_e4m3>::value ? __NV_E4M3 : __NV_E5M2;
    fp8x4_to_float<kind>(r.x, v);
    fp8x4_to_float<kind>(r.y, v + 4);
  }
}

// v = the 8 values of the run at p (16-byte aligned), read through the
// read-only cache.
template <typename KT>
__device__ __forceinline__ void load8(const KT* p, float (&v)[8]) {
  unpack_run<KT>(RawRun<KT>::ldg(p), v);
}

// One element, for rows whose runs straddle channels.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float load1(const __nv_fp8_e4m3* p) {
  return static_cast<float>(*p);
}

__device__ __forceinline__ float load1(const __nv_fp8_e5m2* p) {
  return static_cast<float>(*p);
}

}  // namespace
