// Cached-K iteration, backward (B2-bwd).
//
// Replaces the Pallas backward of graph_pde_tpu/ops/fused_iterate.py:
// _bwd_kernel (per 512-edge block: dmsg = OH @ dpart through the
// block-local one-hot, then dxj = K . dmsg through a selector GEMM).
// Here the one-hot is the receiver index itself. One block of 256
// threads owns one edge e and computes
//
//   dmsg[e, o] = mask[e] * dtotal[recv[e], o]
//   dxj[e, i]  = sum_o K[e, i*out + o] * dmsg[e, o]
//
// with K fp32, bf16 or fp8 e4m3/e5m2 (the 1-byte stream of k_storage),
// upcast exactly in registers. dK = xj (x) dmsg stays
// outside the kernel, as in the JAX package, so the depth steps' dK
// contributions accumulate in K's dtype there.
//
// What bounds it on an H100: bytes. The only large operand is K, read
// once: E * in * out elements (383 k edges * 4096 * 2 bytes ~= 3.1 GB at
// the uai1 s=61 graph in bf16), against 2 FLOPs per element.
//
// What the design does about it: the dmsg row is gathered once into
// shared memory; each thread owns fixed 8-element runs of the K row
// (16-byte loads for bf16, 32-byte for fp32; neighbouring threads read
// neighbouring runs), forms the run's partial dot product with dmsg in
// registers, and the partials of one channel meet in shared memory and
// are summed in a fixed order. A masked-out edge reads no K at all.
// Rows wider than COLS = 4096 columns are taken in passes of COLS; the
// JAX gate makes out divide COLS there, so no channel straddles two
// passes. Where out % 8 != 0 a run may straddle two channels, and the
// kernel multiplies element by element instead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                       // K elements per run
constexpr int COLS = 4096;                   // K columns per pass
constexpr int PER = COLS / (VEC * THREADS);  // runs per thread (2)
constexpr int MAX_OUT = 1024;                // out_ch bound (the JAX gate's)

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[VEC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // bf16 -> fp32 is a 16-bit left shift of the bit pattern
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// fp8 K (e4m3, e5m2) is a storage format: every value is exact in fp16
// and so in fp32. Pairs go through the packed fp8x2 -> f16x2 convert.
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

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p,
                                      float (&v)[VEC]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  fp8x4_to_float<__NV_E4M3>(u.x, v);
  fp8x4_to_float<__NV_E4M3>(u.y, v + 4);
}

__device__ __forceinline__ void load8(const __nv_fp8_e5m2* p,
                                      float (&v)[VEC]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  fp8x4_to_float<__NV_E5M2>(u.x, v);
  fp8x4_to_float<__NV_E5M2>(u.y, v + 4);
}

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

// V8: out_ch % 8 == 0 (a run lies in one channel; red holds one partial
// per run). Otherwise red holds one product per column.
template <typename KT, bool V8>
__global__ void __launch_bounds__(THREADS)
iterate_bwd_kernel(const KT* __restrict__ K,
                   const uint8_t* __restrict__ mask,
                   const int64_t* __restrict__ recv,
                   const float* __restrict__ dtotal,
                   float* __restrict__ dxj, float* __restrict__ dmsg,
                   int in_ch, int out_ch) {
  __shared__ float dm[MAX_OUT];
  __shared__ float red[COLS];
  const int64_t e = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = in_ch * out_ch;
  const bool live = mask[e] != 0;
  const int64_t r = recv[e];

  for (int o = tid; o < out_ch; o += THREADS) {
    const float v = live ? __ldg(dtotal + r * out_ch + o) : 0.f;
    dm[o] = v;
    dmsg[e * out_ch + o] = v;
  }
  if (!live) {
    for (int i = tid; i < in_ch; i += THREADS) dxj[e * in_ch + i] = 0.f;
    return;
  }
  __syncthreads();

  const KT* row = K + e * (int64_t)C;
  for (int c0 = 0; c0 < C; c0 += COLS) {
    const int c1 = C < c0 + COLS ? C : c0 + COLS;
    if constexpr (V8) {
      float kv[PER][VEC];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int c = c0 + (p * THREADS + tid) * VEC;
        if (c < c1) load8(row + c, kv[p]);
      }
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int c = c0 + (p * THREADS + tid) * VEC;
        if (c < c1) {
          const int o0 = c % out_ch;
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) s = fmaf(kv[p][v], dm[o0 + v], s);
          red[(c - c0) / VEC] = s;
        }
      }
    } else {
      for (int c = c0 + tid; c < c1; c += THREADS) {
        red[c - c0] = load1(row + c) * dm[c % out_ch];
      }
    }
    __syncthreads();
    // channels of this pass: [c0 / out, c1 / out), each summed in order
    const int per = V8 ? out_ch / VEC : out_ch;
    for (int i = c0 / out_ch + tid; i < c1 / out_ch; i += THREADS) {
      const float* pr = red + (i * out_ch - c0) / (V8 ? VEC : 1);
      float s = 0.f;
      for (int q = 0; q < per; ++q) s += pr[q];
      dxj[e * in_ch + i] = s;
    }
    __syncthreads();   // red is rewritten by the next pass
  }
}

template <typename KT>
int launch(const KT* K, const uint8_t* mask, const int64_t* recv,
           const float* dtotal, float* dxj, float* dmsg, int64_t E,
           int in_ch, int out_ch, cudaStream_t stream) {
  if (out_ch % VEC == 0) {
    iterate_bwd_kernel<KT, true><<<(unsigned)E, THREADS, 0, stream>>>(
        K, mask, recv, dtotal, dxj, dmsg, in_ch, out_ch);
  } else {
    iterate_bwd_kernel<KT, false><<<(unsigned)E, THREADS, 0, stream>>>(
        K, mask, recv, dtotal, dxj, dmsg, in_ch, out_ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): out_ch <= 1024, K
// contiguous [E, in_ch * out_ch] of the element type named by k_kind
// (0 fp32, 1 bf16, 2 fp8 e4m3, 3 fp8 e5m2), 16-byte aligned, with
// in_ch * out_ch <= 4096 or out_ch dividing 4096; mask [E] bool, recv [E]
// int64, dtotal [nodes, out_ch] fp32. Writes dxj [E, in_ch] and dmsg
// [E, out_ch]. Returns a cudaError_t.
int gpde_iterate_bwd(const void* K, const uint8_t* mask, const int64_t* recv,
                     const float* dtotal, float* dxj, float* dmsg, int64_t E,
                     int in_ch, int out_ch, int k_kind, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (k_kind) {
    case 0:
      return launch(reinterpret_cast<const float*>(K), mask, recv, dtotal,
                    dxj, dmsg, E, in_ch, out_ch, s);
    case 1:
      return launch(reinterpret_cast<const __nv_bfloat16*>(K), mask, recv,
                    dtotal, dxj, dmsg, E, in_ch, out_ch, s);
    case 2:
      return launch(reinterpret_cast<const __nv_fp8_e4m3*>(K), mask, recv,
                    dtotal, dxj, dmsg, E, in_ch, out_ch, s);
    case 3:
      return launch(reinterpret_cast<const __nv_fp8_e5m2*>(K), mask, recv,
                    dtotal, dxj, dmsg, E, in_ch, out_ch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
