// Cached-K iteration, backward (B2-bwd).
//
// Replaces the Pallas backward of graph_pde_tpu/ops/fused_iterate.py:
// _bwd_kernel (per 512-edge block: dmsg = OH @ dpart through the
// block-local one-hot, then dxj = K . dmsg through a selector GEMM).
// Here the one-hot is the receiver index itself:
//
//   dmsg[e, o] = mask[e] * dtotal[recv[e], o]
//   dxj[e, i]  = sum_o K[e, i*out + o] * dmsg[e, o]
//
// with K fp32, bf16 or fp8 e4m3/e5m2 (the 1-byte stream of k_storage),
// upcast exactly in registers. dK = xj (x) dmsg stays outside the
// kernel, as in the JAX package, so the depth steps' dK contributions
// accumulate in K's dtype there.
//
// What bounds it on an H100: bytes. The only large operand is K, read
// once: E * in * out elements (383 k edges * 4096 * 2 bytes ~= 3.1 GB at
// the uai1 s=61 graph in bf16), against 2 FLOPs per element. A masked
// edge reads no K.
//
// What the design does about it. The warp form (out % 8 == 0 and out
// dividing 256: 8, 16, 32, 64, 128, 256; B3's rule) gives one warp one
// edge at a time, several warps per block, in a grid-stride loop sized to
// the card's resident warps. Lane l reads runs l, l + 32, ... of the K
// row through the read-only cache (faster here than streaming loads),
// all of a batch in flight before the first multiply (16 runs, a whole
// 64 x 64 row: 256 B of bf16 or 128 B of fp8 a lane; 8 runs of fp32),
// keeping the raw bytes in registers until the multiply; the dmsg row is
// loaded just after them (receivers are sorted, so neighbouring edges
// hit the caches), so one round trip serves both. Lane l holds dmsg[e,
// o0 .. o0+7] in registers, o0 = 8 * (l % (out/8)); lanes < out/8 write
// the dmsg row. Because 32 runs span whole rows of K, every run of lane
// l starts at column o0; the out/8 lanes of one row i meet by shuffles
// into dxj[e, i]. No shared memory, no block barrier. The next edge's
// mask byte and receiver are read one edge ahead and kept raw, so
// nothing waits on them.
//
// Measured on the H100 (PERF.md): with bf16 K this is faster than
// torch.bmm of K with a bf16 dmsg, though it writes 3 % more bytes (fp32
// dmsg and dxj); the fp8 forms are bound by the fp8 -> fp32 converts
// rather than bytes. A version that keeps the next chunk's loads in
// flight while multiplying, rings of K rows brought into shared memory
// by TMA bulk copies, and bulk prefetches of the next edge's row into
// L2 were all slower.
//
// The general form keeps the block kernel for every other shape the JAX
// gate admits (out not a multiple of 8, out 512 or 1024): one block of
// 256 threads per edge; the dmsg row is gathered into shared memory;
// each thread owns fixed 8-element runs of the K row, or single elements
// where out % 8 != 0, and the partials of one channel meet in shared
// memory, summed in a fixed order. Rows wider than COLS = 4096 columns
// are taken in passes of COLS; the JAX gate makes out divide COLS there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "k_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                       // K elements per run
constexpr int COLS = 4096;                   // K columns per pass
constexpr int PER = COLS / (VEC * THREADS);  // runs per thread (2)
constexpr int MAX_OUT = 1024;                // out_ch bound (the JAX gate's)
constexpr int WARPS = THREADS / 32;

// ------------------------------------------------------------ warp form

// L = out / 8, the lanes of one K row, is a template parameter: as a
// runtime value, its divisions and the shuffle loop made the kernel
// slower than torch.bmm.
template <typename KT, int L>
__global__ void __launch_bounds__(THREADS)
iterate_bwd_warp_kernel(const KT* __restrict__ K,
                        const uint8_t* __restrict__ mask,
                        const int64_t* __restrict__ recv,
                        const float* __restrict__ dtotal,
                        float* __restrict__ dxj, float* __restrict__ dmsg,
                        int64_t E, int in_ch) {
  // runs in flight per lane: 16 of bf16 or fp8 (a whole 64 x 64 row), 8
  // of fp32 (register use)
  constexpr int U = sizeof(KT) == 4 ? 8 : 16;
  constexpr int OUT = L * VEC;
  using Raw = typename RawRun<KT>::type;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  const int runs = in_ch * L;        // runs per edge
  const int o0 = (lane % L) * VEC;   // the lane's output columns
  const int64_t C = (int64_t)in_ch * OUT;

  // The next edge's mask byte and receiver are read one edge ahead and
  // kept raw until used: nothing waits on their loads.
  int64_t e = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  uint8_t m = e < E ? mask[e] : 0;
  int64_t r = e < E ? recv[e] : 0;
  for (; e < E; e += stride) {
    const int64_t en = e + stride;
    const uint8_t m_n = en < E ? mask[en] : 0;
    const int64_t r_n = en < E ? recv[en] : 0;
    const bool live = m != 0;   // warp-uniform: a masked edge reads no K
    const KT* row = K + e * C;
    float* dx = dxj + e * in_ch;
    // the trip counts are the same for every lane (the shuffles need all
    // 32); a row's out/8 lanes are all live or all past the end
    for (int r0 = 0; r0 < runs; r0 += 32 * U) {
      // the batch's K loads first, then the dmsg row (one round trip)
      Raw kv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r0 + u * 32 + lane;
        if (live && rr < runs) kv[u] = RawRun<KT>::ldg(row + (int64_t)rr * VEC);
      }
      float dm[VEC];
      if (live) {
        const float4* q =
            reinterpret_cast<const float4*>(dtotal + r * OUT + o0);
        const float4 x0 = __ldg(q), x1 = __ldg(q + 1);
        dm[0] = x0.x; dm[1] = x0.y; dm[2] = x0.z; dm[3] = x0.w;
        dm[4] = x1.x; dm[5] = x1.y; dm[6] = x1.z; dm[7] = x1.w;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) dm[v] = 0.f;
      }
      if (r0 == 0 && lane < L) {
        float4* q = reinterpret_cast<float4*>(dmsg + e * OUT + o0);
        q[0] = make_float4(dm[0], dm[1], dm[2], dm[3]);
        q[1] = make_float4(dm[4], dm[5], dm[6], dm[7]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 + u * 32 >= runs) break;   // warp-uniform
        const int rr = r0 + u * 32 + lane;
        float p = 0.f;
        if (live && rr < runs) {
          float k[VEC];
          unpack_run<KT>(kv[u], k);
#pragma unroll
          for (int v = 0; v < VEC; ++v) p = fmaf(k[v], dm[v], p);
        }
#pragma unroll
        for (int off = 1; off < L; off <<= 1) {
          p += __shfl_xor_sync(0xffffffffu, p, off);
        }
        if (rr < runs && lane % L == 0) dx[rr / L] = p;
      }
    }
    m = m_n;
    r = r_n;
  }
}

// --------------------------------------------------------- general form

// V8: out_ch % 8 == 0 (a run lies in one channel; red holds one partial
// per run). Otherwise red holds one product per column.
template <typename KT, bool V8>
__global__ void __launch_bounds__(THREADS)
iterate_bwd_block_kernel(const KT* __restrict__ K,
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

template <typename KT, int L>
int launch_warp(const KT* K, const uint8_t* mask, const int64_t* recv,
                const float* dtotal, float* dxj, float* dmsg, int64_t E,
                int in_ch, cudaStream_t stream) {
  // a grid of the current card's resident blocks, at most one warp per
  // edge
  const auto kernel = iterate_bwd_warp_kernel<KT, L>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t need = (E + WARPS - 1) / WARPS;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  kernel<<<grid, THREADS, 0, stream>>>(K, mask, recv, dtotal, dxj, dmsg, E,
                                       in_ch);
  return (int)cudaGetLastError();
}

// The warp form at out_ch = 8 L.
template <typename KT>
int launch_warp(const KT* K, const uint8_t* mask, const int64_t* recv,
                const float* dtotal, float* dxj, float* dmsg, int64_t E,
                int in_ch, int out_ch, cudaStream_t stream) {
  using std::integral_constant;
  auto go = [&](auto l) {
    return launch_warp<KT, decltype(l)::value>(K, mask, recv, dtotal, dxj,
                                               dmsg, E, in_ch, stream);
  };
  switch (out_ch) {
    case 8: return go(integral_constant<int, 1>{});
    case 16: return go(integral_constant<int, 2>{});
    case 32: return go(integral_constant<int, 4>{});
    case 64: return go(integral_constant<int, 8>{});
    case 128: return go(integral_constant<int, 16>{});
    case 256: return go(integral_constant<int, 32>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename KT>
int launch_general(const KT* K, const uint8_t* mask, const int64_t* recv,
                   const float* dtotal, float* dxj, float* dmsg, int64_t E,
                   int in_ch, int out_ch, cudaStream_t stream) {
  if (out_ch % VEC == 0) {
    iterate_bwd_block_kernel<KT, true><<<(unsigned)E, THREADS, 0, stream>>>(
        K, mask, recv, dtotal, dxj, dmsg, in_ch, out_ch);
  } else {
    iterate_bwd_block_kernel<KT, false><<<(unsigned)E, THREADS, 0, stream>>>(
        K, mask, recv, dtotal, dxj, dmsg, in_ch, out_ch);
  }
  return (int)cudaGetLastError();
}

// Calls go(K as its element type) for the K kind code.
template <class Go>
int by_kind(const void* K, int k_kind, Go go) {
  switch (k_kind) {
    case 0: return go(reinterpret_cast<const float*>(K));
    case 1: return go(reinterpret_cast<const __nv_bfloat16*>(K));
    case 2: return go(reinterpret_cast<const __nv_fp8_e4m3*>(K));
    case 3: return go(reinterpret_cast<const __nv_fp8_e5m2*>(K));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): K contiguous
// [E, in_ch * out_ch] of the element type named by k_kind (0 fp32, 1
// bf16, 2 fp8 e4m3, 3 fp8 e5m2), 16-byte aligned; mask [E] bool, recv [E]
// int64, dtotal [nodes, out_ch] fp32, 16-byte aligned. Each writes dxj
// [E, in_ch] and dmsg [E, out_ch] and returns a cudaError_t.
//
// The warp form: out_ch % 8 == 0 and 256 % out_ch == 0.
int gpde_iterate_bwd_warp(const void* K, const uint8_t* mask,
                          const int64_t* recv, const float* dtotal,
                          float* dxj, float* dmsg, int64_t E, int in_ch,
                          int out_ch, int k_kind, void* stream) {
  if (E == 0) return 0;
  if (out_ch % VEC != 0 || 256 % out_ch != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return by_kind(K, k_kind, [&](auto k) {
    return launch_warp(k, mask, recv, dtotal, dxj, dmsg, E, in_ch, out_ch, s);
  });
}

// The general form: out_ch <= 1024, with in_ch * out_ch <= 4096 or
// out_ch dividing 4096.
int gpde_iterate_bwd_general(const void* K, const uint8_t* mask,
                             const int64_t* recv, const float* dtotal,
                             float* dxj, float* dmsg, int64_t E, int in_ch,
                             int out_ch, int k_kind, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return by_kind(K, k_kind, [&](auto k) {
    return launch_general(k, mask, recv, dtotal, dxj, dmsg, E, in_ch, out_ch,
                          s);
  });
}

}  // extern "C"
