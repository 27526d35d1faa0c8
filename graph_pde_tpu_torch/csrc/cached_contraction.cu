// Per-edge contraction against cached kernel matrices (B3), forward and
// backward.
//
// Replaces the Pallas kernels of graph_pde_tpu/ops/cached_contraction.py:
// _fwd_kernel (selector GEMMs over column chunks of K)
//
//   msg[e, o] = sum_i x[e, i] * K[e, i*out + o]
//
// and _bwd_kernel (both cotangents on the same grid, one pass over K)
//
//   dx[e, i]         = sum_o K[e, i*out + o] * g[e, o]
//   dK[e, i*out + o] = x[e, i] * g[e, o]        (rounded to K's dtype)
//
// K is fp32 or bf16, upcast exactly in registers; x, g, msg and dx are
// fp32. Every sum is fp32 in a fixed order: no atomics.
//
// What bounds it on an H100: bytes. K is the only large operand (E * in
// * out elements, read once; the backward also writes dK of the same
// size) against 2 FLOPs per element: at the uai1 s=61 graph (383,488
// edges, 64 x 64) K is 3.1 GB in bf16.
//
// What the design does about it. The fast form (out a multiple of 8
// dividing 256: 8, 16, 32, 64, 128, 256) gives one warp one edge. Lane l
// reads the 8-element runs l, l + 32, l + 64, ... of the K row (16-byte
// loads for bf16, 32-byte for fp32; the warp reads 512 B or 1 KB in a
// row), four runs in flight. Because 32 runs span whole rows of K, every
// run of lane l starts at the same output column o0 = 8 * (l % (out/8)).
// So in the forward each lane keeps 8 fp32 sums over its runs, and the
// lanes that share o0 meet by warp shuffles; in the backward each lane
// holds g[e, o0 .. o0+7] in registers, writes its dK run at once (16- or
// 32-byte stores) and forms its run's part of dx[e, i], which the out/8
// lanes of one row i sum by shuffles. No shared memory, no block barrier.
// Every other shape the JAX gate admits takes the general form: one
// thread per (edge, output column) in the forward, per (edge, input
// channel) in the backward, element by element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "k_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;       // K elements per run
constexpr int UNROLL = 4;    // runs in flight per lane

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // round to nearest even, as torch's float -> bfloat16 cast
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- forward

// Fast form: out % 8 == 0 and 256 % out == 0. One warp per edge.
template <typename KT>
__global__ void __launch_bounds__(THREADS)
contract_fwd_warp_kernel(const float* __restrict__ x,
                         const KT* __restrict__ K, float* __restrict__ msg,
                         int64_t E, int in_ch, int out_ch) {
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= E) return;   // whole warps only: E is uniform per warp
  const int L = out_ch / VEC;      // runs per K row (1 .. 32)
  const int runs = in_ch * L;      // runs per edge
  const KT* row = K + e * (int64_t)in_ch * out_ch;
  const float* xr = x + e * in_ch;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  for (int r0 = 0; r0 < runs; r0 += 32 * UNROLL) {
    float kv[UNROLL][VEC];
    float xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * 32 + lane;
      if (r < runs) {
        load8(row + (int64_t)r * VEC, kv[u]);
        xv[u] = __ldg(xr + r / L);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) kv[u][v] = 0.f;
        xv[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv[u], kv[u][v], acc[v]);
    }
  }
  // lanes l, l + L, l + 2L, ... hold the same output columns
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
    }
  }
  if (lane < L) store8(msg + e * out_ch + lane * VEC, acc);
}

// General form: one thread per (edge, output column).
template <typename KT>
__global__ void __launch_bounds__(THREADS)
contract_fwd_general_kernel(const float* __restrict__ x,
                            const KT* __restrict__ K,
                            float* __restrict__ msg, int64_t E, int in_ch,
                            int out_ch) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= E * out_ch) return;
  const int64_t e = t / out_ch;
  const int o = (int)(t - e * out_ch);
  const KT* row = K + e * (int64_t)in_ch * out_ch + o;
  const float* xr = x + e * in_ch;
  float s = 0.f;
  for (int i = 0; i < in_ch; ++i) {
    s = fmaf(__ldg(xr + i), load1(row + (int64_t)i * out_ch), s);
  }
  msg[t] = s;
}

// --------------------------------------------------------------- backward

// Fast form: out % 8 == 0 and 256 % out == 0. One warp per edge.
template <typename KT>
__global__ void __launch_bounds__(THREADS)
contract_bwd_warp_kernel(const float* __restrict__ x,
                         const KT* __restrict__ K,
                         const float* __restrict__ g,
                         float* __restrict__ dx, KT* __restrict__ dK,
                         int64_t E, int in_ch, int out_ch) {
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= E) return;
  const int L = out_ch / VEC;
  const int runs = in_ch * L;
  const int64_t base = e * (int64_t)in_ch * out_ch;
  const float* xr = x + e * in_ch;

  float gv[VEC];   // g[e, o0 .. o0 + 7], the same for every run of the lane
  {
    const float* gr = g + e * out_ch + (lane % L) * VEC;
    const float4 a = __ldg(reinterpret_cast<const float4*>(gr));
    const float4 b = __ldg(reinterpret_cast<const float4*>(gr + 4));
    gv[0] = a.x; gv[1] = a.y; gv[2] = a.z; gv[3] = a.w;
    gv[4] = b.x; gv[5] = b.y; gv[6] = b.z; gv[7] = b.w;
  }

  // the trip count is the same for every lane (shuffles below need all 32)
  for (int r0 = 0; r0 < runs; r0 += 32 * UNROLL) {
    float kv[UNROLL][VEC];
    float xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * 32 + lane;
      if (r < runs) {
        load8(K + base + (int64_t)r * VEC, kv[u]);
        xv[u] = __ldg(xr + r / L);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) kv[u][v] = 0.f;
        xv[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * 32 + lane;
      float p = 0.f;
      float d[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        p = fmaf(kv[u][v], gv[v], p);
        d[v] = xv[u] * gv[v];
      }
      // the L consecutive lanes of one row i sum its part of dx[e, i];
      // a row's lanes are all live or all past the end together
      for (int off = 1; off < L; off <<= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (r < runs) {
        store8(dK + base + (int64_t)r * VEC, d);
        if (lane % L == 0) dx[e * in_ch + r / L] = p;
      }
    }
  }
}

// General form: one thread per (edge, input channel); it reads and writes
// that channel's out columns of K and dK.
template <typename KT>
__global__ void __launch_bounds__(THREADS)
contract_bwd_general_kernel(const float* __restrict__ x,
                            const KT* __restrict__ K,
                            const float* __restrict__ g,
                            float* __restrict__ dx, KT* __restrict__ dK,
                            int64_t E, int in_ch, int out_ch) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= E * in_ch) return;
  const int64_t e = t / in_ch;
  const int64_t off = t * out_ch;   // == e * in * out + i * out
  const float xi = __ldg(x + t);
  const float* gr = g + e * out_ch;
  float s = 0.f;
  for (int o = 0; o < out_ch; ++o) {
    const float go = __ldg(gr + o);
    s = fmaf(load1(K + off + o), go, s);
    store1(dK + off + o, xi * go);
  }
  dx[t] = s;
}

bool fast_form(int out_ch) { return out_ch % VEC == 0 && 256 % out_ch == 0; }

template <typename KT>
int launch_fwd(const float* x, const KT* K, float* msg, int64_t E, int in_ch,
               int out_ch, cudaStream_t stream) {
  if (fast_form(out_ch)) {
    const unsigned grid = (unsigned)((E + WARPS - 1) / WARPS);
    contract_fwd_warp_kernel<KT><<<grid, THREADS, 0, stream>>>(
        x, K, msg, E, in_ch, out_ch);
  } else {
    const unsigned grid = (unsigned)((E * out_ch + THREADS - 1) / THREADS);
    contract_fwd_general_kernel<KT><<<grid, THREADS, 0, stream>>>(
        x, K, msg, E, in_ch, out_ch);
  }
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_bwd(const float* x, const KT* K, const float* g, float* dx,
               KT* dK, int64_t E, int in_ch, int out_ch,
               cudaStream_t stream) {
  if (fast_form(out_ch)) {
    const unsigned grid = (unsigned)((E + WARPS - 1) / WARPS);
    contract_bwd_warp_kernel<KT><<<grid, THREADS, 0, stream>>>(
        x, K, g, dx, dK, E, in_ch, out_ch);
  } else {
    const unsigned grid = (unsigned)((E * in_ch + THREADS - 1) / THREADS);
    contract_bwd_general_kernel<KT><<<grid, THREADS, 0, stream>>>(
        x, K, g, dx, dK, E, in_ch, out_ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): a shape the JAX gate
// admits (contraction_supported), x [E, in_ch] fp32, K and dK contiguous
// [E, in_ch * out_ch] in fp32 (k_bf16 = 0) or bf16 (k_bf16 = 1), K and
// dK 16-byte aligned, g [E, out_ch] and msg [E, out_ch] fp32, dx
// [E, in_ch] fp32. Each returns a cudaError_t.
int gpde_contract_fwd(const float* x, const void* K, float* msg, int64_t E,
                      int in_ch, int out_ch, int k_bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (k_bf16) {
    return launch_fwd(x, reinterpret_cast<const __nv_bfloat16*>(K), msg, E,
                      in_ch, out_ch, s);
  }
  return launch_fwd(x, reinterpret_cast<const float*>(K), msg, E, in_ch,
                    out_ch, s);
}

int gpde_contract_bwd(const float* x, const void* K, const float* g,
                      float* dx, void* dK, int64_t E, int in_ch, int out_ch,
                      int k_bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (k_bf16) {
    return launch_bwd(x, reinterpret_cast<const __nv_bfloat16*>(K), g, dx,
                      reinterpret_cast<__nv_bfloat16*>(dK), E, in_ch, out_ch,
                      s);
  }
  return launch_bwd(x, reinterpret_cast<const float*>(K), g, dx,
                    reinterpret_cast<float*>(dK), E, in_ch, out_ch, s);
}

}  // extern "C"
