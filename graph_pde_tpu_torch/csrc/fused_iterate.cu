// Cached-K iteration, forward (K2).
//
// Replaces the Pallas forward of graph_pde_tpu/ops/fused_iterate.py:
// _fwd_kernel (per 512-edge receiver-sorted block: contraction against
// the cached K, then a one-hot product onto the block's receivers). Here
// one block of 256 threads owns one receiver node n and computes
//
//   out[n, o] = sum_{e in row n, mask[e]} sum_i x[senders[e], i] * K[e, i*out + o]
//
// over the node's edges, read from the CSR row pointer of the sorted
// receivers. Each node's row is written once: no atomics, deterministic.
// The mask is applied here, so padding edges parked on a real node
// (n == N_pad - 1 when the graph fills its capacity) drop out.
//
// What bounds it on an H100: bytes. The only large operand is K, read
// once per launch: E * in * out elements (1.38 M edges * 4096 * 2 bytes
// ~= 11.3 GB at the s=61 GKN graph in bf16), against 2 FLOPs per element.
//
// What the design does about it: each thread owns fixed 8-element runs
// of a K row (16-byte loads for bf16, 32-byte for fp32; neighbouring
// threads read neighbouring runs, so a warp reads contiguous 512 B or
// 1 KB), upcasts in registers, and keeps fp32 partial sums for its runs
// across all of the node's edges. Edges are taken four at a time so
// each thread has several independent loads in flight. The gather
// x[senders[e]] is folded in (x is small and stays in L2). At the end
// the partial sums meet in shared memory and are reduced over i.
//
// A row of more than COLS = 4096 columns (width > 64) is taken by a
// second kernel in passes of COLS columns, each walking the node's edges
// again; every K element is still read once. Where out % 8 != 0 that
// kernel reads the runs element by element (the vector loads need
// 8-element runs inside one channel).
//
// K may also be fp8 (e4m3 or e5m2): the JAX kernels' 1-byte K stream of
// k_storage. A run is then one 8-byte load, converted pairwise to fp32
// (exactly), so the fp32 arithmetic is the same for every K type. At the
// serving shapes the fp8 streams take their own kernel,
// iterate_total_fp8_kernel, which keeps the raw runs in registers and
// twice the edges in flight (see its note).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "k_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                       // K elements per run
constexpr int COLS = 4096;                   // K columns per pass
constexpr int PER = COLS / (VEC * THREADS);  // runs per thread (2)
constexpr int UNROLL = 4;                    // edges in flight per thread
constexpr int MAX_OUT = 1024;                // out_ch bound (the JAX gate's)

// The serving shapes: out_ch % 8 == 0 and in_ch * out_ch <= COLS, so a
// run is one channel's 8 aligned columns and one pass covers the row.
template <typename KT>
__global__ void __launch_bounds__(THREADS)
iterate_total_kernel(const float* __restrict__ x,
                     const int64_t* __restrict__ senders,
                     const KT* __restrict__ K,
                     const uint8_t* __restrict__ mask,
                     const int64_t* __restrict__ rowptr,
                     float* __restrict__ out, int in_ch, int out_ch) {
  __shared__ float red[COLS];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = in_ch * out_ch;
  const int64_t beg = rowptr[n], end = rowptr[n + 1];

  int cpos[PER], ipos[PER];
  bool act[PER];
  float acc[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    cpos[p] = (p * THREADS + tid) * VEC;
    act[p] = cpos[p] < C;
    ipos[p] = act[p] ? cpos[p] / out_ch : 0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[p][v] = 0.f;
  }

  for (int64_t e = beg; e < end; e += UNROLL) {
    float kv[UNROLL][PER][VEC];
    float xv[UNROLL][PER];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t eu = e + u;
      const bool live = eu < end && mask[eu];
      const int64_t s = live ? senders[eu] : 0;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        if (live && act[p]) {
          load8(K + eu * C + cpos[p], kv[u][p]);
          xv[u][p] = __ldg(x + s * in_ch + ipos[p]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) kv[u][p][v] = 0.f;
          xv[u][p] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[p][v] = fmaf(xv[u][p], kv[u][p][v], acc[p][v]);
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    if (act[p]) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[cpos[p] + v] = acc[p][v];
    }
  }
  __syncthreads();
  for (int o = tid; o < out_ch; o += THREADS) {
    float s = 0.f;
    for (int i = 0; i < in_ch; ++i) s += red[i * out_ch + o];
    out[(int64_t)n * out_ch + o] = s;
  }
}

// The fp8 K streams (k_storage e4m3 / e5m2) at the serving shapes. A run
// is 8 bytes, so the kernel above, which converts each run to 8 fp32
// registers as it loads it, held half the bf16 form's bytes in flight at
// 184 registers and one block an SM. Here the raw runs stay in registers
// (two 32-bit words each) until their multiply, and U = 8 edges are in
// flight: 8 * 2 runs * 8 B = 128 B a thread, the bf16 form's. L = out/8
// is a template parameter for the power-of-two widths (0: a runtime
// width), so a thread's channel and the final reduction need no runtime
// division. The K loads of a batch do not wait for the mask: a masked
// edge's run is loaded but never multiplied (its fp8 NaN or inf would
// otherwise reach the sum).
template <typename KT, int L>
__global__ void __launch_bounds__(THREADS, 2)
iterate_total_fp8_kernel(const float* __restrict__ x,
                         const int64_t* __restrict__ senders,
                         const KT* __restrict__ K,
                         const uint8_t* __restrict__ mask,
                         const int64_t* __restrict__ rowptr,
                         float* __restrict__ out, int in_ch, int out_rt) {
  constexpr int U = 8;
  using Raw = typename RawRun<KT>::type;
  __shared__ float red[COLS];
  const int out_ch = L ? L * VEC : out_rt;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = in_ch * out_ch;
  const int64_t beg = rowptr[n], end = rowptr[n + 1];

  int cpos[PER], ipos[PER];
  bool act[PER];
  float acc[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    cpos[p] = (p * THREADS + tid) * VEC;
    act[p] = cpos[p] < C;
    ipos[p] = act[p] ? cpos[p] / out_ch : 0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[p][v] = 0.f;
  }

  for (int64_t e = beg; e < end; e += U) {
    Raw kv[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t eu = e + u;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        if (eu < end && act[p]) {
          kv[u][p] = RawRun<KT>::ldg(K + eu * C + cpos[p]);
        } else {
          kv[u][p] = Raw{};
        }
      }
    }
    bool live[U];
    float xv[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t eu = e + u;
      live[u] = eu < end && mask[eu];
      const int64_t s = live[u] ? senders[eu] * in_ch : 0;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        xv[u][p] = live[u] && act[p] ? __ldg(x + s + ipos[p]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;   // block-uniform
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        float k[VEC];
        unpack_run<KT>(kv[u][p], k);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[p][v] = fmaf(xv[u][p], k[v], acc[p][v]);
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    if (act[p]) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[cpos[p] + v] = acc[p][v];
    }
  }
  __syncthreads();
  for (int o = tid; o < out_ch; o += THREADS) {
    float s = 0.f;
    for (int i = 0; i < in_ch; ++i) s += red[i * out_ch + o];
    out[(int64_t)n * out_ch + o] = s;
  }
}

// Every other shape: passes of COLS columns, each walking the node's
// edges again, and element-wise loads where out_ch % 8 != 0 (V8 false).
// The same arithmetic; a separate kernel because folding the passes
// into the one above made its bf16 form slower at the serving shapes.
template <typename KT, bool V8>
__global__ void __launch_bounds__(THREADS)
iterate_total_general_kernel(const float* __restrict__ x,
                             const int64_t* __restrict__ senders,
                             const KT* __restrict__ K,
                             const uint8_t* __restrict__ mask,
                             const int64_t* __restrict__ rowptr,
                             float* __restrict__ out, int in_ch,
                             int out_ch) {
  __shared__ float red[COLS];
  __shared__ float osum[MAX_OUT];   // osum[o] is touched by one thread only
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = in_ch * out_ch;
  const int64_t beg = rowptr[n], end = rowptr[n + 1];

  for (int o = tid; o < out_ch; o += THREADS) osum[o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += COLS) {
    int cpos[PER], ipos[PER];
    bool act[PER];
    float acc[PER][VEC];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      cpos[p] = c0 + (p * THREADS + tid) * VEC;
      act[p] = cpos[p] < C;
      ipos[p] = act[p] ? cpos[p] / out_ch : 0;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[p][v] = 0.f;
    }

    for (int64_t e = beg; e < end; e += UNROLL) {
      float kv[UNROLL][PER][VEC];
      float xv[UNROLL][PER][V8 ? 1 : VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t eu = e + u;
        const bool live = eu < end && mask[eu];
        const int64_t s = live ? senders[eu] : 0;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          if constexpr (V8) {
            if (live && act[p]) {
              load8(K + eu * C + cpos[p], kv[u][p]);
              xv[u][p][0] = __ldg(x + s * in_ch + ipos[p]);
            } else {
#pragma unroll
              for (int v = 0; v < VEC; ++v) kv[u][p][v] = 0.f;
              xv[u][p][0] = 0.f;
            }
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const int col = cpos[p] + v;
              const bool ok = live && col < C;
              kv[u][p][v] = ok ? load1(K + eu * C + col) : 0.f;
              xv[u][p][v] = ok ? __ldg(x + s * in_ch + col / out_ch) : 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int p = 0; p < PER; ++p) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[p][v] = fmaf(xv[u][p][V8 ? 0 : v], kv[u][p][v], acc[p][v]);
          }
        }
      }
    }

    __syncthreads();   // the previous pass has finished reading red
#pragma unroll
    for (int p = 0; p < PER; ++p) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (cpos[p] + v < C) red[cpos[p] - c0 + v] = acc[p][v];
      }
    }
    __syncthreads();
    const int c1 = C < c0 + COLS ? C : c0 + COLS;
    for (int o = tid; o < out_ch; o += THREADS) {
      // channels i whose column i * out_ch + o lies in [c0, c1), in order
      float s = osum[o];
      const int i = o >= c0 ? 0 : (c0 - o + out_ch - 1) / out_ch;
      for (int col = i * out_ch + o; col < c1; col += out_ch) {
        s += red[col - c0];
      }
      osum[o] = s;
    }
  }
  for (int o = tid; o < out_ch; o += THREADS) {
    out[(int64_t)n * out_ch + o] = osum[o];
  }
}

template <typename KT>
int launch(const float* x, const int64_t* senders, const KT* K,
           const uint8_t* mask, const int64_t* rowptr, float* out,
           int64_t n_nodes, int in_ch, int out_ch, cudaStream_t stream) {
  const unsigned grid = (unsigned)n_nodes;
  if (out_ch % 8 == 0 && in_ch * out_ch <= COLS) {
    if constexpr (sizeof(KT) == 1) {
      auto go = [&](auto l) {
        iterate_total_fp8_kernel<KT, decltype(l)::value>
            <<<grid, THREADS, 0, stream>>>(x, senders, K, mask, rowptr, out,
                                           in_ch, out_ch);
      };
      switch (out_ch / 8) {
        case 1: go(std::integral_constant<int, 1>{}); break;
        case 2: go(std::integral_constant<int, 2>{}); break;
        case 4: go(std::integral_constant<int, 4>{}); break;
        case 8: go(std::integral_constant<int, 8>{}); break;
        case 16: go(std::integral_constant<int, 16>{}); break;
        case 32: go(std::integral_constant<int, 32>{}); break;
        case 64: go(std::integral_constant<int, 64>{}); break;
        case 128: go(std::integral_constant<int, 128>{}); break;
        default: go(std::integral_constant<int, 0>{});
      }
    } else {
      iterate_total_kernel<KT><<<grid, THREADS, 0, stream>>>(
          x, senders, K, mask, rowptr, out, in_ch, out_ch);
    }
  } else if (out_ch % 8 == 0) {
    iterate_total_general_kernel<KT, true><<<grid, THREADS, 0, stream>>>(
        x, senders, K, mask, rowptr, out, in_ch, out_ch);
  } else {
    iterate_total_general_kernel<KT, false><<<grid, THREADS, 0, stream>>>(
        x, senders, K, mask, rowptr, out, in_ch, out_ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): out_ch <= 1024, K
// contiguous [E, in_ch * out_ch] of the element type named by k_kind
// (0 fp32, 1 bf16, 2 fp8 e4m3, 3 fp8 e5m2), rowptr [n_nodes + 1] over
// receiver-sorted edges, x and K 16-byte aligned. Returns a cudaError_t.
int gpde_iterate_total(const float* x, const int64_t* senders, const void* K,
                       const uint8_t* mask, const int64_t* rowptr, float* out,
                       int64_t n_nodes, int in_ch, int out_ch, int k_kind,
                       void* stream) {
  if (n_nodes == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (k_kind) {
    case 0:
      return launch(x, senders, reinterpret_cast<const float*>(K), mask,
                    rowptr, out, n_nodes, in_ch, out_ch, s);
    case 1:
      return launch(x, senders, reinterpret_cast<const __nv_bfloat16*>(K),
                    mask, rowptr, out, n_nodes, in_ch, out_ch, s);
    case 2:
      return launch(x, senders, reinterpret_cast<const __nv_fp8_e4m3*>(K),
                    mask, rowptr, out, n_nodes, in_ch, out_ch, s);
    case 3:
      return launch(x, senders, reinterpret_cast<const __nv_fp8_e5m2*>(K),
                    mask, rowptr, out, n_nodes, in_ch, out_ch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
