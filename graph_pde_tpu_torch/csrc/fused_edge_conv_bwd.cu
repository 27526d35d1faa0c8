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
// ~2.5 GB of inputs and outputs, so in bf16 the tensor cores' rate is the
// bound (7.8 ms at 989 TFLOP/s), and the fp32 SIMT units (67 TFLOP/s)
// are 15x short of it.
//
// ROUND_BF16 / the tensor-core form mirror compute_dtype='bfloat16' of
// _bwd_merged_kernel_omj: the operands of the three products (h2, Wl,
// dpre) are rounded to bf16 with fp32 accumulation; x is rounded to bf16
// before dpre = x * g, dpre itself is kept in fp32 for dbl; g and the dx
// sum stay fp32. That is exactly what a bf16 tensor-core product with
// fp32 accumulators computes.
//
// Two forms, picked by the caller by shape and compute dtype:
//
// The bf16 tensor-core form (compute_dtype='bfloat16'; kw % 8 == 0, out %
// 8 == 0, out dividing 128; the GKN kappas) runs every product on the
// bf16 tensor cores with fp32 accumulators, 128 x 128 block tiles fed by
// a three-slab cp.async ring of 32-deep bf16 slabs in shared memory. The
// caller casts h2 and Wl to bf16 once (and transposes Wl) so that their
// slabs come by cp.async.
//   tc::dx_dh_kernel, one block per 128 edges, keeps the tile's g and
//     bf16(x[senders]) in shared memory; its two warpgroups issue wgmma
//     m64n128k16 straight from the slabs, which are K-major in the
//     64-byte swizzle the wgmma descriptors describe. (1) h3 = h2 @ Wl
//     one 128-column tile at a time; a tile holds whole channels, so its
//     epilogue multiplies the accumulators by g, meets the four lanes of
//     a row by shuffles and sums each channel's n8 partials in a fixed
//     order into dx_src. (2) dh2 = dpre @ Wl^T over the depth C, 128
//     columns of dh2 at a time; each dpre slab is formed by the threads,
//     rounded to bf16, into shared memory while the previous slab's
//     products run.
//   tc::dw_kernel: dWl = h2^T @ dpre split-K over edge ranges into
//     partial slabs, on mma.sync m16n8k16 (eight warps of 64 x 32; both
//     operands are edge-major in shared memory and ldmatrix.trans reads
//     them); the blocks of the first kw tile also sum the fp32 dpre they
//     form into a partial dbl, so dbl costs no pass of its own.
//     reduce_kernel sums the partials in order s = 0, 1, ...:
//     bit-repeatable, no atomics.
// What holds it back (PERF.md): each slab's wgmma is waited on before
// the next is issued, and the cp.async issue, the dpre formation and the
// block barrier per 32-deep slab take the issue slots; dWl stays on
// mma.sync. A warp-specialized TMA producer and MN-major wgmma for dWl
// are the next steps.
// Neither h3 nor dpre ([E, C]) reaches device memory.
//
// The SIMT form (compute_dtype=None, and bf16 shapes outside the tiles):
// fp32 FMAs on the SIMT units, each product a kernel on a grid of its
// own, so that a call with few edges (the multipole levels have 16 to
// 3,066) still spreads over every SM.
//   dx_kernel, block (edge tile, channel group): for each 128-column
//     tile of the group's whole input channels, h3 = h2 @ Wl[:, tile] in
//     an 8x8 register tile per thread, multiplied by g and summed per
//     input channel through shared memory (a fixed order); each (edge,
//     channel) has one writer.
//   dh_kernel, block (edge tile, 128 columns of dh2, depth split): dh2 =
//     dpre @ Wl^T split-K over the depth C, with dpre generated on the
//     fly as the A operand; with several splits, reduce_kernel sums
//     their partial slabs in order.
//   dw_kernel: dWl = h2^T @ dpre as a split-K product. Block (kt, ct, s)
//     owns a 128 x 128 tile of dWl and the s-th contiguous range of
//     edges, and writes its partial slab; dbl_kernel does the same for
//     dbl over shorter ranges. reduce_kernel sums the partial slabs in
//     order, as above.
// The caller picks the channel groups and depth splits
// (ops/fused_edge_conv.py b1_bwd_simt_grid): enough blocks for two waves
// of two blocks an SM where the tiles allow, one group and one split
// where the edge tiles alone fill the card.
// All operands are streamed through double-buffered 16-deep slabs in
// shared memory, eight per thread per slab: as two float4 loads where kw
// and out are multiples of 8 (the GKN shapes), else element by element
// with bounds checks, so every shape the JAX gate admits (kw <= 2048, any
// in/out) runs through the same code. The product kernels are held to
// 128 registers so that two blocks share an SM. ROUND_BF16 rounds as
// above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90_tc.cuh"

namespace {

constexpr int TE = 128;       // rows of a block's output tile
constexpr int BN = 128;       // columns of a block's output tile
constexpr int BK = 16;        // depth of one staged slab
constexpr int THREADS = 256;
constexpr int RED_LD = BN + 1;  // padded row of the dx staging buffer

// Raises a kernel's dynamic shared memory bound to `bytes` once for each
// device: `done` is the kernel's own set of devices already raised (bit
// d for device ordinal d), so a launch makes no attribute call.
cudaError_t smem_once(const void* kernel, int bytes,
                      std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

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

// dx_src for one tile of TE edges and the input channels [i_lo, i_hi)
// of group blockIdx.y (`per` channels a group): h3 = h2 @ Wl over the
// group's columns, 128 at a time from column i_lo * out, times g, and
// summed per channel through shared memory in a fixed order. Every
// (edge, channel) has this block as its one writer: a channel's first
// piece is stored, its second (a channel across two column tiles)
// added, in tile order. VEC: kw % 8 == 0 and out_ch % 8 == 0, so every
// 8-run of a row lies inside the matrix (and inside one input channel)
// and is read as two float4s.
template <bool RB, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dx_kernel(const float* __restrict__ h2, const float* __restrict__ g,
          const float* __restrict__ wl, float* __restrict__ dx_src,
          int64_t M, int kw, int in_ch, int out_ch, int per) {
  __shared__ __align__(16) float As[2 * BK * TE];
  __shared__ __align__(16) float Bs[2 * BK * BN];
  extern __shared__ float red[];   // [TE][RED_LD]: h3 * g of one tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.x * TE;
  const int C = in_ch * out_ch;
  const int i_lo = blockIdx.y * per;
  const int i_hi = in_ch - i_lo < per ? in_ch : i_lo + per;
  const int c_end = i_hi * out_ch;

  // the A row this thread stages (A_ALONG_K mapping: row tid >> 1)
  const int64_t my_e = m0 + (tid >> 1);
  const bool my_live = my_e < M;
  const float* my_h2 = h2 + (my_live ? my_e * kw : 0);

  // dx_src[e, i] = sum_o (h2 @ Wl)[e, i*out + o] * g[e, o]
  for (int c0 = i_lo * out_ch; c0 < c_end; c0 += BN) {
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
        if (k < kw && cc < c_end) ld8<RB>(p, v); else zero8(v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = (k < kw && cc + q < c_end) ? rnd<RB>(__ldg(p + q)) : 0.f;
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
            (e < M && c0 + col < c_end) ? __ldg(g + e * out_ch + o) : 0.f;
        red[row * RED_LD + col] = c[r][j] * gv;
      }
    }
    __syncthreads();
    // channels i0 .. i1 - 1 touch this tile; each (edge, channel) pair
    // sums its columns in order
    const int c1 = c_end < c0 + BN ? c_end : c0 + BN;
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
      float* d = dx_src + e * in_ch + i;
      if (lo == i * out_ch) *d = s; else *d += s;
    }
    __syncthreads();
  }
}

// dh2[e, k] = sum_c dpre[e, c] * Wl[k, c] for one tile of TE edges and
// 128 columns k0 = 128 blockIdx.y, over the depth range [c_lo, c_hi) of
// split blockIdx.z (`depth` a split, a multiple of BK when there are
// several), dpre generated on the fly as the A operand. Writes split s
// into out + s * M * kw: dh2 itself when there is one split, else the
// partial slabs that reduce_kernel sums in order. VEC as for dx_kernel.
template <bool RB, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dh_kernel(const float* __restrict__ x, const int64_t* __restrict__ senders,
          const float* __restrict__ g, const float* __restrict__ wl,
          float* __restrict__ out, int64_t M, int kw, int in_ch, int out_ch,
          int depth) {
  __shared__ __align__(16) float As[2 * BK * TE];
  __shared__ __align__(16) float Bs[2 * BK * BN];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.x * TE;
  const int k0 = blockIdx.y * BN;
  const int C = in_ch * out_ch;
  const int c_lo = blockIdx.z * depth;
  const int c_hi = C - c_lo < depth ? C : c_lo + depth;

  const int64_t my_e = m0 + (tid >> 1);
  const bool my_live = my_e < M;
  const float* my_x = x + (my_live ? senders[my_e] * in_ch : 0);
  const float* my_g = g + (my_live ? my_e * out_ch : 0);

  float c[8][8];
  zero(c);
  auto fa = [&](int, int kk, float (&v)[8]) {   // dpre[e, c_lo + kk + q]
    const int cc = c_lo + kk;
    if (VEC) {
      if (my_live && cc < c_hi) {
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
        v[q] = (my_live && cq < c_hi)
                   ? rnd<RB>(rnd<RB>(__ldg(my_x + i)) *
                             __ldg(my_g + (cq - i * out_ch)))
                   : 0.f;
      }
    }
  };
  auto fb = [&](int kk, int col, float (&v)[8]) {   // Wl[k0 + col, cc + q]
    const int cc = c_lo + kk;
    const float* p = wl + (int64_t)(k0 + col) * C + cc;
    if (VEC) {
      if (cc < c_hi && k0 + col < kw) ld8<RB>(p, v); else zero8(v);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = (cc + q < c_hi && k0 + col < kw) ? rnd<RB>(__ldg(p + q))
                                                : 0.f;
      }
    }
  };
  tile_gemm<true, false>(c_hi - c_lo, fa, fb, As, Bs, c);
  float* dst = out + (int64_t)blockIdx.z * M * kw;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t e = m0 + tile_row(ty, r);
    if (e >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + tile_col(tx, j);
      if (k < kw) dst[e * kw + k] = c[r][j];
    }
  }
}

// Partial dWl of edge range s: part[s][k][c] = sum_e h2[e, k] * dpre[e, c].
// VEC as for dx_kernel.
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

// ------------------------------------------------ bf16 tensor-core form

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;      // block tile rows
constexpr int BN = 128;      // block tile columns
constexpr int BK = 32;       // depth of one slab (two k16 steps)
constexpr int STAGES = 3;    // slabs in flight (cp.async ring)
constexpr int SLAB = BM * BK * 2;    // bytes of a [128][32] or [32][128] slab
constexpr int RED_LD = BN / 8 + 1;   // padded row of the dx partials
// dx_dh_kernel's slab ring: phase 1's A and B slabs, or phase 2's B
// slabs and two dpre slabs
constexpr int RING = 2 * STAGES * SLAB;

// A [32][128] bf16 slab: rows of sixteen chunks, XOR-ed with row % 8.
__device__ __forceinline__ uint32_t off_n128(int row, int ch) {
  return row * 256 + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm4t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b on the bf16 tensor cores, fp32 accumulators (16 x 8 x 16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's accumulators: [m16 tile][n8 tile][fragment], fragment q at row
// lane/4 + 8 * (q / 2), column 2 * (lane % 4) + q % 2 of its n8 tile.
__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
}

// acc += A . B over one slab of depth 32 for this warp's 64 x 32 part of
// a 128 x 128 tile (rows 64 * (warp % 2), columns 32 * (warp / 2)); A
// [32 k][128 m] and B [32 k][128 n] slabs (m, n contiguous), read
// transposed by ldmatrix.
__device__ __forceinline__ void mma_slab_t(uint32_t sa, uint32_t sb,
                                           float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = wm * 64 + mi * 16 + (j & 1) * 8;
      ldsm4t(sa + off_n128(ks * 16 + (j >> 1) * 8 + r, m >> 3), a[mi]);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int n = wn * 32 + nj * 16 + (j >> 1) * 8;
      ldsm4t(sb + off_n128(ks * 16 + (j & 1) * 8 + r, n >> 3), b[nj]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma16816(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                 b[ni >> 1][(ni & 1) * 2 + 1]);
  }
}

constexpr size_t dx_dh_smem(int in_ch, int out_ch) {
  return 512 + RING + sizeof(float) * BM * out_ch + sizeof(bf16) * BM * in_ch +
         sizeof(float) * BM * RED_LD;
}

// in_ch bound of this form: with out_ch <= BN, the dx/dh2 kernel's shared
// memory then fits one block's 227 KiB on the H100
constexpr int MAX_IN = 256;
static_assert(dx_dh_smem(MAX_IN, BN) <= 232448,
              "the tensor-core form's in_ch bound must fit shared memory");

constexpr size_t kDwSmem = (STAGES + 2) * SLAB + sizeof(float) * 16 * BN;

// dx_src and dh2 for one tile of BM = 128 edges (see the file's note).
// h2b [M, kw], wlt = Wl^T [C, kw] and wlb = Wl [kw, C] in bf16. Each of
// the two warpgroups owns 64 of the tile's edges and issues m64n128k16
// wgmma on the slabs in shared memory (A and B both K-major, 64-byte
// swizzle), accumulators in registers in the m16n8 fragment order (n8
// tile j at d[4j .. 4j+3]). Dynamic shared memory (dx_dh_smem): 512
// bytes of alignment slack, the slab ring, g [BM][out] fp32,
// bf16(x[senders]) [BM][in] and the dx partials [BM][RED_LD].
__global__ void __launch_bounds__(256, 2)
dx_dh_kernel(const bf16* __restrict__ h2b, const bf16* __restrict__ wlt,
                const bf16* __restrict__ wlb, const float* __restrict__ x,
                const int64_t* __restrict__ senders,
                const float* __restrict__ g, float* __restrict__ dx_src,
                float* __restrict__ dh2, int64_t M, int kw, int in_ch,
                int out_ch) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 511) & ~511u) - raw_s;   // swizzle atoms
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw_s + pad;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7;                     // warpgroup: rows 64 * wg
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int C = in_ch * out_ch;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  float* gs = reinterpret_cast<float*>(smem + RING);
  bf16* xs = reinterpret_cast<bf16*>(gs + BM * out_ch);
  float* red = reinterpret_cast<float*>(xs + BM * in_ch);

  for (int q = tid; q < BM * out_ch; q += 256) {
    const int r = q / out_ch;
    const int64_t e = m0 + r;
    gs[q] = e < M ? __ldg(g + e * out_ch + (q - r * out_ch)) : 0.f;
  }
  for (int q = tid; q < BM * in_ch; q += 256) {
    const int r = q / in_ch;
    const int64_t e = m0 + r;
    xs[q] = __float2bfloat16_rn(
        e < M ? __ldg(x + senders[e] * in_ch + (q - r * in_ch)) : 0.f);
  }

  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;

  // d (+)= A . B over one 32-deep slab pair: two k16 steps, the
  // descriptors advanced by 32 bytes inside the swizzle atom
  auto mma = [&](uint32_t sa, uint32_t sb, bool first) {
    const uint64_t da = wg_desc(sa + wg * 64 * 64), db = wg_desc(sb);
    wg_fence();
    wgmma_64x128(d, da, db, first ? 0 : 1);
    wgmma_64x128(d, da + 2, db + 2, 1);
    wg_commit_wait();
  };

  // 1. h3 = h2 @ Wl per 128-column tile, dx_src in its epilogue
  const int nka = (kw + BK - 1) / BK;
  const int total_a = (C / BN) * nka;
  auto load_a = [&](int it) {
    if (it < total_a) {
      const int ct = it / nka, kt = it - ct * nka;
      const uint32_t sa = ring + (it % STAGES) * 2 * SLAB, sb = sa + SLAB;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = tid + q * 256, r = idx >> 2, ch = idx & 3;
        const int k = kt * BK + ch * 8;
        const int64_t e = m0 + r;
        const bool oka = e < M && k < kw;
        cp16(sa + off_k32(r, ch), oka ? h2b + e * kw + k : h2b, oka);
        const bool okb = k < kw;
        cp16(sb + off_k32(r, ch),
             okb ? wlt + (int64_t)(ct * BN + r) * kw + k : wlt, okb);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_a(s);
  for (int it = 0; it < total_a; ++it) {
    cp_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_a(it + STAGES - 1);
    const int kt = it % nka;
    const uint32_t sa = ring + (it % STAGES) * 2 * SLAB;
    mma(sa, sa + SLAB, kt == 0);
    if (kt != nka - 1) continue;
    const int c0 = (it / nka) * BN;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = wrow + hi * 8;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        const int o = (c0 + col) % out_ch;
        const float2 gv =
            *reinterpret_cast<const float2*>(gs + row * out_ch + o);
        float p = d[4 * j + 2 * hi] * gv.x + d[4 * j + 2 * hi + 1] * gv.y;
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        if ((lane & 3) == 0) red[row * RED_LD + j] = p;
      }
    }
    __syncthreads();
    const int per = out_ch / 8, nch = BN / out_ch;
    for (int q = tid; q < BM * nch; q += 256) {
      const int row = q % BM, ch = q / BM;
      const int64_t e = m0 + row;
      if (e < M) {
        float s = 0.f;
        for (int j = 0; j < per; ++j) s += red[row * RED_LD + ch * per + j];
        dx_src[e * in_ch + c0 / out_ch + ch] = s;
      }
    }
  }
  __syncthreads();   // every warp is done with the ring

  // 2. dh2 = dpre @ Wl^T per 128-column tile of dh2, depth C
  const int nkb = C / BK;
  const int total_b = ((kw + BN - 1) / BN) * nkb;
  const uint32_t gen = ring + STAGES * SLAB;   // two dpre slabs
  auto load_b = [&](int it) {
    if (it < total_b) {
      const int nt = it / nkb, kt = it - nt * nkb;
      const uint32_t sb = ring + (it % STAGES) * SLAB;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = tid + q * 256, r = idx >> 2, ch = idx & 3;
        const int kout = nt * BN + r;
        const bool ok = kout < kw;
        cp16(sb + off_k32(r, ch),
             ok ? wlb + (int64_t)kout * C + kt * BK + ch * 8 : wlb, ok);
      }
    }
    cp_commit();
  };
  auto form = [&](int it) {
    if (it >= total_b) return;
    const int kt = it % nkb;
    unsigned char* sa = smem + STAGES * SLAB + (it & 1) * SLAB;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * 256, r = idx >> 2, ch = idx & 3;
      const int c = kt * BK + ch * 8;
      const int i = c / out_ch, o = c - i * out_ch;
      const float xv = __bfloat162float(xs[r * in_ch + i]);
      const float4 g0 = *reinterpret_cast<const float4*>(gs + r * out_ch + o);
      const float4 g1 =
          *reinterpret_cast<const float4*>(gs + r * out_ch + o + 4);
      uint4 v;
      v.x = pack_bf16(xv * g0.x, xv * g0.y);
      v.y = pack_bf16(xv * g0.z, xv * g0.w);
      v.z = pack_bf16(xv * g1.x, xv * g1.y);
      v.w = pack_bf16(xv * g1.z, xv * g1.w);
      *reinterpret_cast<uint4*>(sa + off_k32(r, ch)) = v;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_b(s);
  form(0);
  for (int it = 0; it < total_b; ++it) {
    cp_wait<STAGES - 2>();
    // the generated slab (generic stores) and the copied one, before the
    // tensor cores read them through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_b(it + STAGES - 1);
    form(it + 1);
    const int kt = it % nkb;
    mma(gen + (it & 1) * SLAB, ring + (it % STAGES) * SLAB, kt == 0);
    if (kt != nkb - 1) continue;
    const int n0 = (it / nkb) * BN;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int64_t e = m0 + wrow + hi * 8;
      if (e >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + (lane & 3) * 2;
        if (col < kw) {
          *reinterpret_cast<float2*>(dh2 + e * kw + col) =
              make_float2(d[4 * j + 2 * hi], d[4 * j + 2 * hi + 1]);
        }
      }
    }
  }
}

// Partial dWl (and, in the blocks of the first kw tile, partial dbl) of
// edge range s: part_w[s][k][c] = sum_e bf16(h2[e, k]) * bf16(dpre[e, c])
// and part_b[s][c] = sum_e dpre[e, c] with dpre in fp32. Block (kt, ct, s)
// owns a BM x BN tile of dWl; its eight warps hold 64 x 32 parts of it
// and run mma.sync m16n8k16 on operands read by ldmatrix.trans (both are
// edge-major in shared memory). Dynamic shared memory (kDwSmem): STAGES
// h2 slabs [32 e][128 k], two dpre slabs [32 e][128 c] and the dbl
// partials [16][BN].
__global__ void __launch_bounds__(256, 2)
dw_kernel(const bf16* __restrict__ h2b, const float* __restrict__ x,
          const int64_t* __restrict__ senders, const float* __restrict__ g,
          float* __restrict__ part_w, float* __restrict__ part_b, int64_t M,
          int kw, int in_ch, int out_ch, int64_t per_split) {
  constexpr int CR = BN / 8;           // chunks of a dpre row (16)
  constexpr int RG = 256 / CR;         // row groups of the threads (16)
  constexpr int RPT = BK / RG;         // dpre rows a thread forms (2)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int C = in_ch * out_ch;
  const int k0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int64_t e0 = (int64_t)blockIdx.z * per_split;
  const int64_t e1 = e0 + per_split < M ? e0 + per_split : M;
  const int nk = e1 > e0 ? (int)((e1 - e0 + BK - 1) / BK) : 0;
  const bool with_dbl = blockIdx.x == 0;
  const uint32_t ring = smem_u32(smem);
  const uint32_t gen = ring + STAGES * SLAB;
  float* dbl_red = reinterpret_cast<float*>(smem + (STAGES + 2) * SLAB);

  auto load_a = [&](int kt) {
    if (kt < nk) {
      const uint32_t sa = ring + (kt % STAGES) * SLAB;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = tid + q * 256, r = idx >> 4, ch = idx & 15;
        const int64_t e = e0 + (int64_t)kt * BK + r;
        const int k = k0 + ch * 8;
        const bool ok = e < e1 && k < kw;
        cp16(sa + off_n128(r, ch), ok ? h2b + e * kw + k : h2b, ok);
      }
    }
    cp_commit();
  };

  // The thread forms dpre on columns c0 + 8 * cq .. + 8 (one channel) of
  // slab rows RPT * (tid / CR) + rr. Its operands for slab kt + 1 are
  // fetched before the products of slab kt and stored after them; the
  // senders one slab earlier still.
  const int cq = tid % CR;
  const int ci = (c0 + cq * 8) / out_ch, co = c0 + cq * 8 - ci * out_ch;
  const int r0 = (tid / CR) * RPT;
  float fx[RPT];
  float4 fg[RPT][2];
  int64_t sn[RPT];
  float dsum[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) dsum[v] = 0.f;
  auto senders_of = [&](int kt) {
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int64_t e = e0 + (int64_t)kt * BK + r0 + rr;
      sn[rr] = kt < nk && e < e1 ? senders[e] : 0;
    }
  };
  auto fetch = [&](int kt) {
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int64_t e = e0 + (int64_t)kt * BK + r0 + rr;
      if (kt < nk && e < e1) {
        fx[rr] = __ldg(x + sn[rr] * in_ch + ci);
        const float4* gp = reinterpret_cast<const float4*>(g + e * out_ch + co);
        fg[rr][0] = __ldg(gp);
        fg[rr][1] = __ldg(gp + 1);
      } else {
        fx[rr] = 0.f;
        fg[rr][0] = fg[rr][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    senders_of(kt + 1);
  };
  auto put = [&](int kt) {
    if (kt >= nk) return;
    const uint32_t sb = gen + (kt & 1) * SLAB;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const float xv = __bfloat162float(__float2bfloat16_rn(fx[rr]));
      const float gv[8] = {fg[rr][0].x, fg[rr][0].y, fg[rr][0].z, fg[rr][0].w,
                           fg[rr][1].x, fg[rr][1].y, fg[rr][1].z, fg[rr][1].w};
      float p[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        p[v] = xv * gv[v];
        dsum[v] += p[v];
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       sb + off_n128(r0 + rr, cq)),
                   "r"(pack_bf16(p[0], p[1])), "r"(pack_bf16(p[2], p[3])),
                   "r"(pack_bf16(p[4], p[5])), "r"(pack_bf16(p[6], p[7]))
                   : "memory");
    }
  };

  float acc[4][4][4];
  zero_acc(acc);
  senders_of(0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_a(s);
  fetch(0);
  put(0);
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    load_a(kt + STAGES - 1);
    fetch(kt + 1);
    mma_slab_t(ring + (kt % STAGES) * SLAB, gen + (kt & 1) * SLAB, acc);
    put(kt + 1);
  }

  float* out = part_w + (int64_t)blockIdx.z * kw * C;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int k = k0 + wm * 64 + mi * 16 + (lane >> 2) + hi * 8;
      if (k >= kw) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = c0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + (int64_t)k * C + col) =
            make_float2(acc[mi][ni][hi * 2], acc[mi][ni][hi * 2 + 1]);
      }
    }
  }
  if (with_dbl) {   // the RG row groups of each column, summed in order
#pragma unroll
    for (int v = 0; v < 8; ++v) dbl_red[(tid / CR) * BN + cq * 8 + v] = dsum[v];
    __syncthreads();
    if (tid < BN) {
      float t = 0.f;
      for (int q = 0; q < RG; ++q) t += dbl_red[q * BN + tid];
      part_b[(int64_t)blockIdx.z * C + c0 + tid] = t;
    }
  }
}

}  // namespace tc

constexpr size_t kRedSmem = sizeof(float) * TE * RED_LD;

template <bool RB, bool VEC>
int launch(const float* h2, const float* x, const int64_t* senders,
           const float* g, const float* wl, float* dx_src, float* dh2,
           float* dwl, float* dbl, float* part_w, float* part_b,
           float* part_h, int64_t M, int kw, int in_ch, int out_ch,
           int splits, int dbl_splits, int x_per, int h_depth,
           cudaStream_t stream) {
  const int C = in_ch * out_ch;
  const unsigned et = (unsigned)((M + TE - 1) / TE);
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = smem_once(
      reinterpret_cast<const void*>(dx_kernel<RB, VEC>), (int)kRedSmem,
      ready);
  if (err != cudaSuccess) return (int)err;
  const int gx = (in_ch + x_per - 1) / x_per;
  dx_kernel<RB, VEC><<<dim3(et, (unsigned)gx), THREADS, kRedSmem, stream>>>(
      h2, g, wl, dx_src, M, kw, in_ch, out_ch, x_per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int hs = (C + h_depth - 1) / h_depth;
  const dim3 hgrid(et, (unsigned)((kw + BN - 1) / BN), (unsigned)hs);
  dh_kernel<RB, VEC><<<hgrid, THREADS, 0, stream>>>(
      x, senders, g, wl, hs > 1 ? part_h : dh2, M, kw, in_ch, out_ch,
      h_depth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (hs > 1) {
    const int64_t nh = M * kw;
    reduce_kernel<<<(unsigned)((nh + THREADS - 1) / THREADS), THREADS, 0,
                    stream>>>(part_h, hs, nh, dh2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

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

int launch_tc(const __nv_bfloat16* h2b, const __nv_bfloat16* wlt,
              const __nv_bfloat16* wlb, const float* x, const int64_t* senders,
              const float* g, float* dx_src, float* dh2, float* dwl,
              float* dbl, float* part_w, float* part_b, int64_t M, int kw,
              int in_ch, int out_ch, int splits, cudaStream_t stream) {
  const int C = in_ch * out_ch;
  const size_t smem1 = tc::dx_dh_smem(in_ch, out_ch);
  cudaError_t err = cudaFuncSetAttribute(
      tc::dx_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  tc::dx_dh_kernel<<<(unsigned)((M + tc::BM - 1) / tc::BM), 256, smem1,
                     stream>>>(h2b, wlt, wlb, x, senders, g, dx_src, dh2, M,
                               kw, in_ch, out_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(tc::dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tc::kDwSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_split = (M + splits - 1) / splits;
  const dim3 wgrid((unsigned)((kw + tc::BM - 1) / tc::BM),
                   (unsigned)(C / tc::BN), (unsigned)splits);
  tc::dw_kernel<<<wgrid, 256, tc::kDwSmem, stream>>>(
      h2b, x, senders, g, part_w, part_b, M, kw, in_ch, out_ch, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t nw = (int64_t)kw * C;
  reduce_kernel<<<(unsigned)((nw + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(part_w, splits, nw, dwl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((C + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(part_b, splits, C, dbl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): h2 [M, kw], x
// [nodes, in_ch], senders [M] int64, g [M, out_ch], Wl [kw, in_ch *
// out_ch], all fp32, contiguous and 16-byte aligned, C = in_ch * out_ch
// < 2^31. dx_src [M, in_ch], dh2 [M, kw], dWl [kw, C] and dbl [C] are
// written (nothing needs zeroing). The dx kernel runs in ceil(in_ch /
// x_per) groups of x_per input channels, the dh kernel in ceil(C /
// h_depth) splits of the depth C (h_depth a multiple of 16, or >= C).
// part_w [splits, kw, C], part_b [dbl_splits, C] and, with several dh
// splits, part_h [splits of dh, M, kw] are scratch. Returns a
// cudaError_t (cudaErrorInvalidValue for a grid off these rules).
int gpde_edge_messages_bwd(const float* h2, const float* x,
                           const int64_t* senders, const float* g,
                           const float* wl, float* dx_src, float* dh2,
                           float* dwl, float* dbl, float* part_w,
                           float* part_b, float* part_h, int64_t M, int kw,
                           int in_ch, int out_ch, int splits,
                           int dbl_splits, int x_per, int h_depth,
                           int round_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int C = in_ch * out_ch;
  if (M == 0) {
    cudaError_t err = cudaMemsetAsync(dwl, 0, sizeof(float) * (size_t)kw * C,
                                      s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(dbl, 0, sizeof(float) * (size_t)C, s);
  }
  if (x_per < 1 || h_depth < 1 || (h_depth % BK != 0 && h_depth < C) ||
      (in_ch + x_per - 1) / x_per > 65535 ||
      (C + h_depth - 1) / h_depth > 65535 ||
      (h_depth < C && part_h == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = kw % 8 == 0 && out_ch % 8 == 0;
  auto go = [&](auto rb, auto v) {
    return launch<decltype(rb)::value, decltype(v)::value>(
        h2, x, senders, g, wl, dx_src, dh2, dwl, dbl, part_w, part_b, part_h,
        M, kw, in_ch, out_ch, splits, dbl_splits, x_per, h_depth, s);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (round_bf16) return vec ? go(T{}, T{}) : go(T{}, F{});
  return vec ? go(F{}, T{}) : go(F{}, F{});
}

// The bf16 tensor-core form (compute_dtype='bfloat16'): h2b [M, kw], wlb
// = Wl [kw, C] and wlt = Wl^T [C, kw] in bf16 (rounded to nearest even
// by the caller); x, senders, g as above. kw % 8 == 0, out_ch % 8 == 0,
// out_ch dividing 128, C % 128 == 0, in_ch <= tc::MAX_IN (256), every
// tensor 16-byte aligned. dx_src [M, in_ch], dh2, dWl and dbl are written (nothing needs
// zeroing); part_w [splits, kw, C] and part_b [splits, C] are scratch.
// Returns a cudaError_t.
int gpde_edge_messages_bwd_tc(const void* h2b, const void* wlt,
                              const void* wlb, const float* x,
                              const int64_t* senders, const float* g,
                              float* dx_src, float* dh2, float* dwl,
                              float* dbl, float* part_w, float* part_b,
                              int64_t M, int kw, int in_ch, int out_ch,
                              int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int C = in_ch * out_ch;
  if (kw % 8 != 0 || out_ch % 8 != 0 || tc::BN % out_ch != 0 ||
      C % tc::BN != 0 || in_ch > tc::MAX_IN || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) {
    cudaError_t err = cudaMemsetAsync(dwl, 0, sizeof(float) * (size_t)kw * C, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(dbl, 0, sizeof(float) * (size_t)C, s);
  }
  using B = const __nv_bfloat16*;
  return launch_tc(reinterpret_cast<B>(h2b), reinterpret_cast<B>(wlt),
                   reinterpret_cast<B>(wlb), x, senders, g, dx_src, dh2, dwl,
                   dbl, part_w, part_b, M, kw, in_ch, out_ch, splits, s);
}

}  // extern "C"
