// Fused edge messages, backward of the last kappa layer and the
// contraction (B1-bwd).
//
// Replaces the Pallas backward of graph_pde_tpu/ops/pallas_edge_conv.py:
// _bwd_merged_kernel_omj (the default form), _bwd_dx_kernel_omj,
// _bwd_dw_kernel_omj, _bwd_dx_kernel_res, _bwd_dw_kernel_res,
// _bwd_dx_kernel and _bwd_dw_kernel: one function in seven TPU layouts.
// With h2 the recomputed last hidden activations, Wl [kw, C] the last
// layer's weight (C = in * out, column c = i * out + o) and g [E, out]
// the messages' cotangent, it computes
//
//   h3[e, c]     = sum_k h2[e, k] * Wl[k, c]        (no bias)
//   dx_src[e, i] = sum_o h3[e, i*out + o] * g[e, o]
//   dpre[e, c]   = x[senders[e], i] * g[e, o]
//   dh2[e, k]    = sum_c dpre[e, c] * Wl[k, c]
//   dWl[k, c]    = sum_e h2[e, k] * dpre[e, c]
//   dbl[c]       = sum_e dpre[e, c]
//
// Neither h3 nor dpre ([E, C]) is ever written to device memory: each
// is formed tile by tile in registers or shared memory.
//
// What bounds it on an H100: operations. Three products of E * kw * C
// multiply-adds each (3x the forward's last layer): at the uai4 shape
// (E 1,225,728 padded, kw 256, C 4096) about 7.7 TFLOP per call against
// ~2.5 GB of inputs and outputs. This first version runs on the fp32 SIMT units
// (67 TFLOP/s), not the tensor cores.
//
// What the design does about it: three kernels per call.
//   dx_dh_kernel, one block per tile of 128 edges: for each 128-column
//     tile, h3 = h2 @ Wl[:, tile] in an 8x8 register tile per thread,
//     multiplied by g and summed per input channel through shared
//     memory (a fixed order); then dh2 = dpre @ Wl^T, 128 columns of dh2
//     at a time, with dpre generated on the fly as the A operand.
//   dw_kernel: dWl = h2^T @ dpre as a split-K product. Block (kt, ct, s)
//     owns a 128 x 128 tile of dWl and the s-th contiguous range of
//     edges, and writes its partial slab; dbl_kernel does the same for
//     dbl over shorter ranges. reduce_kernel sums the partial slabs in
//     order s = 0, 1, ..., so the result is bit-repeatable (no atomics
//     anywhere).
// All operands are streamed through double-buffered 16-deep slabs in
// shared memory, eight per thread per slab: as two float4 loads where kw
// and out are multiples of 8 (the GKN shapes), else element by element
// with bounds checks, so every shape the JAX gate admits (kw <= 2048, any
// in/out) runs through the same code. Both product kernels are held to
// 128 registers so that two blocks share an SM.
//
// ROUND_BF16 mirrors compute_dtype='bfloat16' of _bwd_merged_kernel_omj:
// the operands of the three products (h2, Wl, dpre) are rounded to bf16
// with fp32 accumulation; x is rounded to bf16 before dpre = x * g, dpre
// itself is kept in fp32 for dbl; g and the dx sum stay fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TE = 128;       // rows of a block's output tile
constexpr int BN = 128;       // columns of a block's output tile
constexpr int BK = 16;        // depth of one staged slab
constexpr int THREADS = 256;
constexpr int RED_LD = BN + 1;  // padded row of the dx staging buffer

template <bool RB>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (RB) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Row and column of register-tile element (r, j) of this thread.
__device__ __forceinline__ int tile_row(int ty, int r) {
  return (r < 4) ? ty * 4 + r : 64 + ty * 4 + (r - 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

__device__ __forceinline__ void zero(float (&c)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[r][j] = 0.f;
  }
}

// c[r][j] += sum_kk as[kk][row(r)] * bs[kk][col(j)] over one staged slab.
__device__ __forceinline__ void slab_fma(const float* __restrict__ as,
                                         const float* __restrict__ bs,
                                         float (&c)[8][8]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[8], b[8];
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * TE + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(as + kk * TE + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(bs + kk * BN + 64 + tx * 4);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[r][j] = fmaf(a[r], b[j], c[r][j]);
    }
  }
}

// v = the 8 floats at p (16-byte aligned), rounded.
template <bool RB>
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = rnd<RB>(a.x); v[1] = rnd<RB>(a.y);
  v[2] = rnd<RB>(a.z); v[3] = rnd<RB>(a.w);
  v[4] = rnd<RB>(b.x); v[5] = rnd<RB>(b.y);
  v[6] = rnd<RB>(b.z); v[7] = rnd<RB>(b.w);
}

__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = 0.f;
}

// c[r][j] += sum_{k < K} A(row(r), k) * B(k, col(j)).
// Each thread stages eight operands of A and eight of B per slab through
// fa(row, k, v) and fb(k, col, v), which fill v with operands (already
// rounded, zero outside the matrix); row, col in [0, 128), k global.
// A_ALONG_K: v[q] = A(row, k + q) (for A contiguous in k), otherwise
// A(row + q, k). B_ALONG_COL: v[q] = B(k, col + q), otherwise
// B(k + q, col). As, Bs: shared, 2 x [BK][128] each. Ends with a barrier.
template <bool A_ALONG_K, bool B_ALONG_COL, class FA, class FB>
__device__ __forceinline__ void tile_gemm(int K, FA fa, FB fb,
                                          float* __restrict__ As,
                                          float* __restrict__ Bs,
                                          float (&c)[8][8]) {
  const int tid = threadIdx.x;
  const int a_row = A_ALONG_K ? tid >> 1 : (tid & 15) * 8;
  const int a_k = A_ALONG_K ? (tid & 1) * 8 : tid >> 4;
  const int b_col = B_ALONG_COL ? (tid & 15) * 8 : tid >> 1;
  const int b_k = B_ALONG_COL ? tid >> 4 : (tid & 1) * 8;
  const int nk = (K + BK - 1) / BK;
  float sa[8], sb[8];

  auto fetch = [&](int kt) {
    fa(a_row, kt * BK + a_k, sa);
    fb(kt * BK + b_k, b_col, sb);
  };
  auto stash = [&](int buf) {
    float* as = As + buf * (BK * TE);
    float* bs = Bs + buf * (BK * BN);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (A_ALONG_K) {
        as[(a_k + q) * TE + a_row] = sa[q];
      } else {
        as[a_k * TE + a_row + q] = sa[q];
      }
      if (B_ALONG_COL) {
        bs[b_k * BN + b_col + q] = sb[q];
      } else {
        bs[(b_k + q) * BN + b_col] = sb[q];
      }
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);
    slab_fma(As + (kt & 1) * (BK * TE), Bs + (kt & 1) * (BK * BN), c);
    if (kt + 1 < nk) stash((kt + 1) & 1);
    __syncthreads();
  }
}

// dx_src and dh2 for one tile of TE edges (see the header). VEC: kw % 8
// == 0 and out_ch % 8 == 0, so every 8-run of a row lies inside the
// matrix (and inside one input channel) and is read as two float4s.
template <bool RB, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dx_dh_kernel(const float* __restrict__ h2, const float* __restrict__ x,
             const int64_t* __restrict__ senders, const float* __restrict__ g,
             const float* __restrict__ wl, float* __restrict__ dx_src,
             float* __restrict__ dh2, int64_t M, int kw, int in_ch,
             int out_ch) {
  __shared__ __align__(16) float As[2 * BK * TE];
  __shared__ __align__(16) float Bs[2 * BK * BN];
  extern __shared__ float red[];   // [TE][RED_LD]: h3 * g of one tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.x * TE;
  const int C = in_ch * out_ch;

  // the A row this thread stages (A_ALONG_K mapping: row tid >> 1)
  const int64_t my_e = m0 + (tid >> 1);
  const bool my_live = my_e < M;
  const float* my_h2 = h2 + (my_live ? my_e * kw : 0);
  const float* my_x = x + (my_live ? senders[my_e] * in_ch : 0);
  const float* my_g = g + (my_live ? my_e * out_ch : 0);

  // 1. dx_src[e, i] = sum_o (h2 @ Wl)[e, i*out + o] * g[e, o]
  for (int c0 = 0; c0 < C; c0 += BN) {
    float c[8][8];
    zero(c);
    auto fa = [&](int, int k, float (&v)[8]) {
      if (VEC) {
        if (my_live && k < kw) ld8<RB>(my_h2 + k, v); else zero8(v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = (my_live && k + q < kw) ? rnd<RB>(__ldg(my_h2 + k + q))
                                         : 0.f;
        }
      }
    };
    auto fb = [&](int k, int col, float (&v)[8]) {
      const int cc = c0 + col;
      const float* p = wl + (int64_t)k * C + cc;
      if (VEC) {
        if (k < kw && cc < C) ld8<RB>(p, v); else zero8(v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = (k < kw && cc + q < C) ? rnd<RB>(__ldg(p + q)) : 0.f;
        }
      }
    };
    tile_gemm<true, true>(kw, fa, fb, As, Bs, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tile_col(tx, j);
      const int o = (c0 + col) % out_ch;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = tile_row(ty, r);
        const int64_t e = m0 + row;
        const float gv =
            (e < M && c0 + col < C) ? __ldg(g + e * out_ch + o) : 0.f;
        red[row * RED_LD + col] = c[r][j] * gv;
      }
    }
    __syncthreads();
    // channels i0 .. i1 - 1 touch this tile; each (edge, channel) pair
    // sums its columns in order and adds to dx_src (this block alone
    // owns these rows; a channel split across two tiles is added twice,
    // in tile order)
    const int c1 = C < c0 + BN ? C : c0 + BN;
    const int i0 = c0 / out_ch, i1 = (c1 - 1) / out_ch + 1;
    const int nseg = i1 - i0;
    for (int p = tid; p < TE * nseg; p += THREADS) {
      const int row = p % TE;
      const int i = i0 + p / TE;
      const int64_t e = m0 + row;
      if (e >= M) continue;
      const int lo = i * out_ch > c0 ? i * out_ch : c0;
      const int hi = (i + 1) * out_ch < c1 ? (i + 1) * out_ch : c1;
      float s = 0.f;
      for (int cc = lo; cc < hi; ++cc) s += red[row * RED_LD + (cc - c0)];
      dx_src[e * in_ch + i] += s;
    }
    __syncthreads();
  }

  // 2. dh2[e, k] = sum_c dpre[e, c] * Wl[k, c], 128 columns of dh2 at a time
  for (int k0 = 0; k0 < kw; k0 += BN) {
    float c[8][8];
    zero(c);
    auto fa = [&](int, int cc, float (&v)[8]) {   // dpre[e, cc + q]
      if (VEC) {
        if (my_live && cc < C) {
          const int i = cc / out_ch;
          const float xv = rnd<RB>(__ldg(my_x + i));
          ld8<false>(my_g + (cc - i * out_ch), v);
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = rnd<RB>(xv * v[q]);
        } else {
          zero8(v);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int cq = cc + q;
          const int i = cq / out_ch;
          v[q] = (my_live && cq < C)
                     ? rnd<RB>(rnd<RB>(__ldg(my_x + i)) *
                               __ldg(my_g + (cq - i * out_ch)))
                     : 0.f;
        }
      }
    };
    auto fb = [&](int cc, int col, float (&v)[8]) {   // Wl[k0 + col, cc + q]
      const float* p = wl + (int64_t)(k0 + col) * C + cc;
      if (VEC) {
        if (cc < C && k0 + col < kw) ld8<RB>(p, v); else zero8(v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = (cc + q < C && k0 + col < kw) ? rnd<RB>(__ldg(p + q)) : 0.f;
        }
      }
    };
    tile_gemm<true, false>(C, fa, fb, As, Bs, c);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t e = m0 + tile_row(ty, r);
      if (e >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + tile_col(tx, j);
        if (k < kw) dh2[e * kw + k] = c[r][j];
      }
    }
  }
}

// Partial dWl of edge range s: part[s][k][c] = sum_e h2[e, k] * dpre[e, c].
// VEC as for dx_dh_kernel.
template <bool RB, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dw_kernel(const float* __restrict__ h2, const float* __restrict__ x,
          const int64_t* __restrict__ senders, const float* __restrict__ g,
          float* __restrict__ part, int64_t M, int kw, int in_ch, int out_ch,
          int64_t per_split) {
  __shared__ __align__(16) float As[2 * BK * TE];
  __shared__ __align__(16) float Bs[2 * BK * BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * TE;
  const int c0 = blockIdx.y * BN;
  const int C = in_ch * out_ch;
  const int64_t e0 = (int64_t)blockIdx.z * per_split;
  const int64_t e1 = e0 + per_split < M ? e0 + per_split : M;
  const int64_t n = e1 > e0 ? e1 - e0 : 0;
  // the channel and first output of this thread's B run (B_ALONG_COL
  // mapping: columns c0 + (tid & 15) * 8 + q)
  const int my_c = c0 + (tid & 15) * 8;
  const int my_i = my_c / out_ch, my_o = my_c - my_i * out_ch;

  float c[8][8];
  zero(c);
  auto fa = [&](int row, int k, float (&v)[8]) {   // h2[e0 + k, k0 + row + q]
    const float* p = h2 + (e0 + k) * kw + k0 + row;
    if (VEC) {
      if (k < n && k0 + row < kw) ld8<RB>(p, v); else zero8(v);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = (k < n && k0 + row + q < kw) ? rnd<RB>(__ldg(p + q)) : 0.f;
      }
    }
  };
  auto fb = [&](int k, int, float (&v)[8]) {   // dpre[e0 + k, my_c + q]
    if (k >= n) {
      zero8(v);
      return;
    }
    const int64_t e = e0 + k;
    const float* xs = x + senders[e] * in_ch;
    if (VEC) {
      if (my_c < C) {
        const float xv = rnd<RB>(__ldg(xs + my_i));
        ld8<false>(g + e * out_ch + my_o, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = rnd<RB>(xv * v[q]);
      } else {
        zero8(v);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int cq = my_c + q;
        const int i = cq / out_ch;
        v[q] = cq < C ? rnd<RB>(rnd<RB>(__ldg(xs + i)) *
                                __ldg(g + e * out_ch + (cq - i * out_ch)))
                      : 0.f;
      }
    }
  };
  tile_gemm<false, true>((int)n, fa, fb, As, Bs, c);

  float* out = part + (int64_t)blockIdx.z * kw * C;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = k0 + tile_row(ty, r);
    if (k >= kw) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = c0 + tile_col(tx, j);
      if (cc < C) out[(int64_t)k * C + cc] = c[r][j];
    }
  }
}

// Partial dbl of edge range s: part[s][c] = sum_e dpre[e, c], dpre in
// fp32 (bf16 x, unrounded product). Two threads per column split the
// range by parity and meet in shared memory.
template <bool RB>
__global__ void __launch_bounds__(THREADS)
dbl_kernel(const float* __restrict__ x, const int64_t* __restrict__ senders,
           const float* __restrict__ g, float* __restrict__ part, int64_t M,
           int in_ch, int out_ch, int64_t per_split) {
  __shared__ float half[THREADS];
  const int tid = threadIdx.x;
  const int C = in_ch * out_ch;
  const int cc = blockIdx.x * (THREADS / 2) + (tid & 127);
  const int par = tid >> 7;
  const int64_t e0 = (int64_t)blockIdx.y * per_split;
  const int64_t e1 = e0 + per_split < M ? e0 + per_split : M;
  float s = 0.f;
  if (cc < C) {
    const int i = cc / out_ch, o = cc - i * out_ch;
#pragma unroll 4
    for (int64_t e = e0 + par; e < e1; e += 2) {
      s += rnd<RB>(__ldg(x + senders[e] * in_ch + i)) *
           __ldg(g + e * out_ch + o);
    }
  }
  half[tid] = s;
  __syncthreads();
  if (par == 0 && cc < C) {
    part[(int64_t)blockIdx.y * C + cc] = half[tid] + half[tid + 128];
  }
}

// out[j] = sum_{s < S} part[s][j], in order of s.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, int S, int64_t n,
              float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int q = 0; q < S; ++q) s += part[(int64_t)q * n + j];
  out[j] = s;
}

constexpr size_t kRedSmem = sizeof(float) * TE * RED_LD;

template <bool RB, bool VEC>
int launch(const float* h2, const float* x, const int64_t* senders,
           const float* g, const float* wl, float* dx_src, float* dh2,
           float* dwl, float* dbl, float* part_w, float* part_b, int64_t M,
           int kw, int in_ch, int out_ch, int splits, int dbl_splits,
           cudaStream_t stream) {
  const int C = in_ch * out_ch;
  cudaError_t err = cudaFuncSetAttribute(
      dx_dh_kernel<RB, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kRedSmem);
  if (err != cudaSuccess) return (int)err;
  dx_dh_kernel<RB, VEC><<<(unsigned)((M + TE - 1) / TE), THREADS, kRedSmem,
                     stream>>>(h2, x, senders, g, wl, dx_src, dh2, M, kw,
                               in_ch, out_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t per_split = (M + splits - 1) / splits;
  const dim3 wgrid((unsigned)((kw + TE - 1) / TE),
                   (unsigned)((C + BN - 1) / BN), (unsigned)splits);
  dw_kernel<RB, VEC><<<wgrid, THREADS, 0, stream>>>(
      h2, x, senders, g, part_w, M, kw, in_ch, out_ch, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per_dbl = (M + dbl_splits - 1) / dbl_splits;
  const dim3 bgrid((unsigned)((C + THREADS / 2 - 1) / (THREADS / 2)),
                   (unsigned)dbl_splits);
  dbl_kernel<RB><<<bgrid, THREADS, 0, stream>>>(x, senders, g, part_b, M,
                                                in_ch, out_ch, per_dbl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t nw = (int64_t)kw * C;
  reduce_kernel<<<(unsigned)((nw + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(part_w, splits, nw, dwl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((C + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(part_b, dbl_splits, C, dbl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): h2 [M, kw], x
// [nodes, in_ch], senders [M] int64, g [M, out_ch], Wl [kw, in_ch *
// out_ch], all fp32, contiguous and 16-byte aligned, C = in_ch * out_ch
// < 2^31. dx_src
// [M, in_ch] must be zeroed by the caller; dh2 [M, kw], dWl [kw, C] and
// dbl [C] are written. part_w [splits, kw, C] and part_b [dbl_splits, C]
// are scratch. Returns a
// cudaError_t.
int gpde_edge_messages_bwd(const float* h2, const float* x,
                           const int64_t* senders, const float* g,
                           const float* wl, float* dx_src, float* dh2,
                           float* dwl, float* dbl, float* part_w,
                           float* part_b, int64_t M, int kw, int in_ch,
                           int out_ch, int splits, int dbl_splits,
                           int round_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M == 0) {
    cudaError_t err = cudaMemsetAsync(
        dwl, 0, sizeof(float) * (size_t)kw * in_ch * out_ch, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(dbl, 0,
                                sizeof(float) * (size_t)in_ch * out_ch, s);
  }
  const bool vec = kw % 8 == 0 && out_ch % 8 == 0;
  auto go = [&](auto rb, auto v) {
    return launch<decltype(rb)::value, decltype(v)::value>(
        h2, x, senders, g, wl, dx_src, dh2, dwl, dbl, part_w, part_b, M, kw,
        in_ch, out_ch, splits, dbl_splits, s);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (round_bf16) return vec ? go(T{}, T{}) : go(T{}, F{});
  return vec ? go(F{}, T{}) : go(F{}, F{});
}

}  // extern "C"
