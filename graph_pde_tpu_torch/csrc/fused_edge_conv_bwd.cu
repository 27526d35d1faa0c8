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
// bf16 tensor cores with fp32 accumulators, on Hopper's asynchronous
// pipeline. The caller casts h2 and Wl to bf16 once (and transposes Wl);
// the host entry re-encodes a TMA tensor map only where its tensor's
// address or shape differs from the previous call's.
// Each kernel is one block an SM of 384 threads: warp 8 is a TMA producer
// that keeps a ring of up to eight 64-deep stages in the 128-byte
// swizzle full (full/empty mbarriers), warps 9-11 load what TMA cannot
// (gathers), and two consumer warpgroups (setmaxnreg 224) issue wgmma and
// keep a group in flight (wgmma.wait_group 1 or 2, never 0 inside a loop).
// No block-wide barrier runs after the start.
//   tc::dx_dh_kernel, one block per 128 edges. The tile's h2 [128][kw]
//     lands in shared memory once (streamed through the ring where it
//     does not fit, kw > 448 at in = out = 64, with a ring of six stages
//     at least, since a phase-1 slab then takes two); g and bf16(x[senders])
//     are loaded by the loader warps. (1) h3 = h2 @ Wl, one 128-column
//     tile at a time over the Wl^T stages, two accumulator sets in turn:
//     the epilogue of tile t (times g, the four lanes of a row met by
//     shuffles, each channel's columns folded in a fixed order into
//     dx_src) runs while the second and third slabs of tile t + 1 are on
//     the tensor cores. (2) dh2 = dpre @ Wl^T over the depth C, 256
//     columns of dh2 a pass: dpre = bf16(bf16(x) * g) is formed in
//     registers as the A fragments of wgmma m64n128k16 (A in registers,
//     B the Wl stages), one set formed while the other set's products
//     run.
//   tc::dw_kernel: dWl = h2^T @ dpre split-K over edge ranges into
//     partial slabs (b1_bwd_tc_splits), block (kt, ct, s) a 128 x 256
//     tile of dWl walked in 64-edge slabs: TMA brings h2 [64 e][128 k],
//     g and the senders; the loader warps gather x[senders] (cp.async,
//     completing on an mbarrier); the consumers form dpre [64 e][256 c]
//     into one of three shared slots while the previous slab's products
//     run, and issue wgmma m64n256k16 with both edge-major operands read
//     through MN-major descriptors. The blocks of the first kw tile also
//     sum the fp32 dpre they form into a partial dbl. reduce_kernel sums
//     the partial slabs in order s = 0, 1, ...: bit-repeatable, no
//     atomics.
// What bounds it now, and what still holds it back: at the uai4 shape
// (E 1.21 M, kw 256, C 4096) on an H100 the two kernels take about 14.5
// and 7 ms against 5.2 and 2.6 ms of tensor-core time. Shared memory is
// the tight resource: wgmma reading both operands from it, TMA writing
// the stages and the threads reading g and writing dpre together ask
// for about its 128 bytes a clock in phase 1 of dx_dh and in dw, so the
// dx epilogue and the dpre formation cost nearly their full time even
// where they overlap the products. Phase 2 runs at about 40 % of the
// tensor rate with formation on its critical path. Next steps: dw with
// dpre in registers (its A fragment is edge-transposed against g's
// layout), a 2-CTA cluster multicasting the Wl stages, a persistent grid.
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90_tc.cuh"
#include "sm90_async.cuh"

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
constexpr int BM = 128;          // edges of a dx/dh2 tile; dWl rows of a block
constexpr int BN = 128;          // h3 columns of a dx tile
constexpr int NT = 384;          // two consumer warpgroups, one producer
constexpr int NC = 256;          // consumer threads
constexpr int NF = 96;           // loader threads (producer warps 1-3)
constexpr int TILE = BM * 64 * 2;     // a [128][64] bf16 tile: 16 KB
constexpr int MAXST = 8;         // ring stages at most
constexpr int XS = 4;            // dw's gathered-x buffers
constexpr int SMEM_MAX = 232448;      // a block's shared memory on the H100
constexpr int BAR_BYTES = 8 * (2 * MAXST + 2 * XS + 3);
// named barriers (0 is __syncthreads)
constexpr int BAR_LOAD = 1;      // the loader threads
constexpr int BAR_CONS = 2;      // the consumer threads

// in_ch bound of this form: with out_ch <= BN, the planners below still
// find a pipeline for it (checked after them)
constexpr int MAX_IN = 256;

constexpr int up(int v, int a) { return (v + a - 1) / a * a; }

// Shared memory of dx_dh_kernel, from its 1024-byte-aligned base: the ring
// of `stages` TILE stages; the tile's h2 when it stays resident (`a_res`,
// else it streams through the ring); g [BM][gld] fp32; bf16(x[senders])
// [BM][in]; the barriers.
struct DxDhPlan {
  int stages, a_res, gld, region, g_off, x_off, bar_off, smem;
};

// Ring stages dx_dh_kernel holds at once. Phase 1 holds three slabs (the
// previous tile's last two and the next tile's first, then slabs 0-2),
// each one stage with h2 resident and two (h2 and Wl^T) with h2 streamed;
// phase 2 holds two slabs of up to two stages. With fewer stages the
// producer waits on a stage no consumer frees.
constexpr int ring_need(int a_res) { return a_res ? 4 : 6; }
constexpr bool plan_ok(const DxDhPlan& p) {
  return p.stages >= ring_need(p.a_res);
}

constexpr DxDhPlan plan_dx_dh(int kw, int in_ch, int out_ch) {
  for (int a_res = 1; a_res >= 0; --a_res) {
    for (int pad = 8; pad >= 0; pad -= 8) {
      DxDhPlan p{};
      p.a_res = a_res;
      p.gld = out_ch + pad;
      const int h2 = (kw + 63) / 64 * TILE;
      p.region = a_res ? h2 : 0;
      const int fixed = p.region + up(BM * p.gld * 4, 1024) +
                        up(BM * in_ch * 2, 1024) + BAR_BYTES + 1024;
      const int st = (SMEM_MAX - fixed) / TILE;
      p.stages = st < MAXST ? st : MAXST;
      if (!plan_ok(p)) continue;
      p.g_off = p.stages * TILE + p.region;
      p.x_off = p.g_off + up(BM * p.gld * 4, 1024);
      p.bar_off = p.x_off + up(BM * in_ch * 2, 1024);
      p.smem = p.bar_off + BAR_BYTES + 1024;
      return p;
    }
  }
  return DxDhPlan{};
}

// Shared memory of dw_kernel: `stages` stages of {h2 [64 e][128 k] as two
// 128-byte-swizzle tiles, g [64][out] fp32, senders [64]}, DW_SLOTS dpre
// tiles [64 e][256 c] (four 64-column blocks of 8 KB each), XS gathered x
// [64][256 / out] fp32, the dbl partials [8][256] and the barriers.
struct DwPlan {
  int stages, stage_bytes, g_off, s_off, slot_off, x_off, x_bytes, red_off,
      bar_off, smem;
};

constexpr int DW_SLOT = 64 * 256 * 2;
constexpr int DW_SLOTS = 3;

constexpr DwPlan plan_dw(int out_ch) {
  DwPlan p{};
  p.g_off = 16384;
  p.s_off = p.g_off + up(64 * out_ch * 4, 128);
  p.stage_bytes = up(p.s_off + 64 * 8, 1024);
  p.x_bytes = up(64 * (256 / out_ch) * 4, 128);
  const int fixed =
      DW_SLOTS * DW_SLOT + XS * p.x_bytes + 8 * 256 * 4 + BAR_BYTES + 1024;
  const int st = (SMEM_MAX - fixed) / p.stage_bytes;
  p.stages = st < MAXST ? st : MAXST;
  p.slot_off = p.stages * p.stage_bytes;
  p.x_off = p.slot_off + DW_SLOTS * DW_SLOT;
  p.red_off = p.x_off + XS * p.x_bytes;
  p.bar_off = p.red_off + 8 * 256 * 4;
  p.smem = p.bar_off + BAR_BYTES + 1024;
  return p;
}

// the widest g and x: h2 resident at a small kw, streamed at a large one
// (the streamed ring does not depend on kw)
static_assert(plan_ok(plan_dx_dh(8, MAX_IN, BN)) &&
                  plan_dx_dh(8, MAX_IN, BN).a_res &&
                  plan_ok(plan_dx_dh(2048, MAX_IN, BN)) &&
                  plan_dw(BN).stages >= 2 && plan_dw(8).stages >= 2,
              "the tensor-core form's in_ch bound must fit shared memory");

// The block's barriers: the ring's full/empty pairs, dw's gathered-x
// full/empty pairs, and three of one use.
struct Bars {
  uint32_t base;
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (MAXST + s); }
  __device__ uint32_t xfull(int b) const {
    return base + 8 * (2 * MAXST + b);
  }
  __device__ uint32_t xempty(int b) const {
    return base + 8 * (2 * MAXST + XS + b);
  }
  __device__ uint32_t one(int k) const {
    return base + 8 * (2 * MAXST + 2 * XS + k);
  }
};

// dx_src and dh2 for one tile of BM = 128 edges (see the file's note).
// Warps 0-7 are two consumer warpgroups, each owning 64 of the tile's
// edges; warp 8 issues the TMA loads; warps 9-11 load g and bf16(x) of
// the tile. tm_h2: h2b [M, kw], tm_wlt: Wl^T [C, kw], tm_wl: Wl [kw, C],
// all bf16 with 64 x 128 boxes in the 128-byte swizzle.
__global__ void __launch_bounds__(NT, 1)
dx_dh_kernel(const __grid_constant__ CUtensorMap tm_h2,
             const __grid_constant__ CUtensorMap tm_wlt,
             const __grid_constant__ CUtensorMap tm_wl,
             const float* __restrict__ x, const int64_t* __restrict__ senders,
             const float* __restrict__ g, float* __restrict__ dx_src,
             float* __restrict__ dh2, int64_t M, int kw, int in_ch,
             int out_ch, DxDhPlan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 1023) & ~1023u) - raw_s;
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw_s + pad;
  const uint32_t region = ring + p.stages * TILE;
  float* gs = reinterpret_cast<float*>(smem + p.g_off);
  bf16* xs = reinterpret_cast<bf16*>(smem + p.x_off);
  const Bars bar{ring + p.bar_off};
  const uint32_t h2_full = bar.one(0), g_full = bar.one(1),
                 x_full = bar.one(2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = in_ch * out_ch;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int nk1 = (kw + 63) / 64;    // 64-deep slabs of phase 1
  const int nct = C / BN;            // 128-column tiles of h3
  // an even number of them: an odd count's last one reads zeros (past C)
  // and writes nothing, so that no wgmma is issued under a branch
  const int nct2 = (nct + 1) & ~1;
  const int nk2 = C / 64;            // 64-deep slabs of phase 2
  const int npass = (kw + 255) / 256;    // 256-column passes of dh2

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar.full(s), 1);
      mbar_init(bar.empty(s), 2);
    }
    mbar_init(h2_full, 1);
    mbar_init(g_full, 1);
    mbar_init(x_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    regs_dec<56>();
    if (warp == 8) {
      if (lane != 0) return;
      // the TMA producer: h2 once, then the ring in the consumers' order
      uint32_t it = 0;
      auto next = [&](const CUtensorMap* tm, int c0, int c1) {
        const int s = (int)(it % p.stages);
        mbar_wait(bar.empty(s), ((it / p.stages) & 1) ^ 1);
        mbar_expect_tx(bar.full(s), TILE);
        tma_load_2d(ring + s * TILE, tm, bar.full(s), c0, c1);
        ++it;
      };
      if (p.a_res) {
        mbar_expect_tx(h2_full, nk1 * TILE);
        for (int kb = 0; kb < nk1; ++kb) {
          tma_load_2d(region + kb * TILE, &tm_h2, h2_full, kb * 64, (int)m0);
        }
      }
      for (int ct = 0; ct < nct2; ++ct) {
        for (int kb = 0; kb < nk1; ++kb) {
          if (!p.a_res) next(&tm_h2, kb * 64, (int)m0);
          next(&tm_wlt, kb * 64, ct * BN);
        }
      }
      for (int pass = 0; pass < npass; ++pass) {
        const int halves = kw - pass * 256 > 128 ? 2 : 1;
        for (int kc = 0; kc < nk2; ++kc) {
          for (int h = 0; h < halves; ++h) {
            next(&tm_wl, kc * 64, pass * 256 + h * 128);
          }
        }
      }
      return;
    }
    // loaders: g (for the dx epilogue and dpre), then bf16(x[senders])
    const int ft = tid - 9 * 32;
    const int q4 = out_ch / 4;
    for (int q = ft; q < BM * q4; q += NF) {
      const int r = q / q4, c4 = q - r * q4;
      const int64_t e = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < M) v = __ldg(reinterpret_cast<const float4*>(g + e * out_ch) + c4);
      *reinterpret_cast<float4*>(gs + r * p.gld + 4 * c4) = v;
    }
    bar_sync(BAR_LOAD, NF);
    if (ft == 0) mbar_arrive(g_full);
#pragma unroll 8
    for (int q = ft; q < BM * in_ch; q += NF) {
      const int r = q / in_ch;
      const int64_t e = m0 + r;
      xs[q] = __float2bfloat16_rn(
          e < M ? __ldg(x + senders[e] * in_ch + (q - r * in_ch)) : 0.f);
    }
    bar_sync(BAR_LOAD, NF);
    if (ft == 0) mbar_arrive(x_full);
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
  regs_inc<224>();
  const int wg = warp >> 2;
  const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const bool leader = (tid & 127) == 0;
  float acc0[64], acc1[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc0[q] = acc1[q] = 0.f;
  pin(acc0);
  pin(acc1);

  uint32_t it = 0;          // ring stages taken
  uint32_t freed = 0;       // ring stages handed back to the producer
  auto take = [&]() {
    const int s = (int)(it % p.stages);
    mbar_wait(bar.full(s), (it / p.stages) & 1);
    ++it;
    return ring + s * TILE;
  };
  // hands back every stage before `upto` (its products are done)
  auto free_upto = [&](uint32_t upto) {
    for (; freed < upto; ++freed) {
      if (leader) mbar_arrive(bar.empty((int)(freed % p.stages)));
    }
  };

  // 1. h3 = h2 @ Wl per 128-column tile; dx_src in the epilogue of each
  // tile, run while the second and third slabs of the next tile are on
  // the tensor cores (the first one's stage already handed back)
  if (p.a_res) mbar_wait(h2_full, 0);
  auto issue1 = [&](float (&acc)[64], int kb) {
    const uint32_t first = it;
    const uint32_t a = (p.a_res ? region + kb * TILE : take()) + wg * 8192;
    const uint32_t b = take();
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_64x128(acc, desc_k128(a + 32 * k), desc_k128(b + 32 * k),
                   (kb > 0 || k > 0) ? 1 : 0);
    }
    wg_commit();
    return first;
  };
  // dx_src[e, i] = sum_o h3[e, i*out + o] * g[e, o]: each thread folds its
  // columns of a channel in order, then the four lanes of a row meet
  const int per = out_ch >> 3;            // n8 tiles of a channel
  const int lper = __ffs(per) - 1;
  const int nch = BN / out_ch;
  auto epilogue = [&](const float (&acc)[64], int ct) {
    if (ct < 0 || ct >= nct) return;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + hi * 8;
      const int64_t e = m0 + row;
      const float* gr = gs + row * p.gld;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int o = (j * 8 + (lane & 3) * 2) & (out_ch - 1);
        const float2 gv = *reinterpret_cast<const float2*>(gr + o);
        s = fmaf(acc[4 * j + 2 * hi], gv.x, s);
        s = fmaf(acc[4 * j + 2 * hi + 1], gv.y, s);
        if (((j + 1) & (per - 1)) == 0) {
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if ((lane & 3) == 0 && e < M) {
            dx_src[e * in_ch + ct * nch + (j >> lper)] = s;
          }
          s = 0.f;
        }
      }
    }
  };
  // Slab 0 is peeled (the compiler sees the previous tile's accumulators
  // complete where the epilogue reads them); then two slabs in flight.
  auto tile = [&](float (&acc)[64], int ct, const float (&prev)[64]) {
    const uint32_t f0 = issue1(acc, 0);
    wg_wait<1>();   // the previous tile's last groups are done
    free_upto(f0);
    if (ct == 1) mbar_wait(g_full, 0);   // before the first epilogue
    if (nk1 < 3) {
      epilogue(prev, ct - 1);
      if (nk1 == 2) {
        const uint32_t f1 = issue1(acc, 1);
        wg_wait<1>();
        free_upto(f1);
      }
      return;
    }
    const uint32_t f1 = issue1(acc, 1);
    uint32_t f = issue1(acc, 2);
    wg_wait<2>();   // slab 0 is done
    free_upto(f1);
    epilogue(prev, ct - 1);
    for (int kb = 3; kb < nk1; ++kb) {
      const uint32_t fn = issue1(acc, kb);
      wg_wait<2>();
      free_upto(f);
      f = fn;
    }
  };
  for (int ct = 0; ct < nct2; ct += 2) {
    tile(acc0, ct, acc1);
    tile(acc1, ct + 1, acc0);
  }
  wg_wait<0>();
  free_upto(it);
  epilogue(acc1, nct2 - 1);

  // 2. dh2 = dpre @ Wl^T, 256 columns of dh2 a pass (two accumulators of
  // 128), depth C in 64-deep slabs. dpre = bf16(bf16(x) * g) is formed in
  // registers as the wgmma's A fragments: rows row0 and row0 + 8, columns
  // 2 (lane % 4) + {0, 1, 8, 9} of each k16 step.
  mbar_wait(x_full, 0);
  const int lout = __ffs(out_ch) - 1;
  const float* gr0 = gs + row0 * p.gld;
  const float* gr1 = gr0 + 8 * p.gld;
  const bf16* xr0 = xs + row0 * in_ch;
  const bf16* xr1 = xr0 + 8 * in_ch;
  uint32_t fa[16], fb[16];
  auto form = [&](uint32_t (&f)[16], int kc) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {   // k16 step t / 2, columns + 8 (t % 2)
      const int c = kc * 64 + t * 8;
      const int i = c >> lout;
      const int o = c - (i << lout) + (lane & 3) * 2;
      const float x0 = __bfloat162float(xr0[i]);
      const float x1 = __bfloat162float(xr1[i]);
      const float2 g0 = *reinterpret_cast<const float2*>(gr0 + o);
      const float2 g1 = *reinterpret_cast<const float2*>(gr1 + o);
      f[2 * t] = pack_bf16(x0 * g0.x, x0 * g0.y);
      f[2 * t + 1] = pack_bf16(x1 * g1.x, x1 * g1.y);
    }
  };
  auto store = [&](const float (&acc)[64], int n0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int64_t e = m0 + row0 + hi * 8;
      if (e >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + (lane & 3) * 2;
        if (col < kw) {
          *reinterpret_cast<float2*>(dh2 + e * kw + col) =
              make_float2(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
        }
      }
    }
  };
  // One slab of a pass; TWO: both 128-column halves (kw beyond 128). Its
  // fragments are formed while the previous slab's products run; their set
  // was last read two slabs back.
  auto slab2 = [&](uint32_t (&f)[16], int kc, auto two_c) {
    constexpr bool TWO = decltype(two_c)::value;
    form(f, kc);
    const uint32_t first = it;
    const uint32_t b0 = take();
    const uint32_t b1 = TWO ? take() : b0;
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_64x128_rs(acc0, f[4 * k], f[4 * k + 1], f[4 * k + 2],
                      f[4 * k + 3], desc_k128(b0 + 32 * k),
                      (kc > 0 || k > 0) ? 1 : 0);
    }
    if constexpr (TWO) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_64x128_rs(acc1, f[4 * k], f[4 * k + 1], f[4 * k + 2],
                        f[4 * k + 3], desc_k128(b1 + 32 * k),
                        (kc > 0 || k > 0) ? 1 : 0);
      }
    }
    wg_commit();
    wg_wait<1>();
    free_upto(first);   // the previous slab's stages
  };
  // nk2 = C / 64 is even (C % 128 == 0): the slabs alternate fa and fb
  auto pass_run = [&](int pass, auto two_c) {
    for (int kc = 0; kc < nk2; kc += 2) {
      slab2(fa, kc, two_c);
      slab2(fb, kc + 1, two_c);
    }
    wg_wait<0>();
    free_upto(it);
    store(acc0, pass * 256);
    if constexpr (decltype(two_c)::value) store(acc1, pass * 256 + 128);
  };
  for (int pass = 0; pass < npass; ++pass) {
    if (kw - pass * 256 > 128) {
      pass_run(pass, std::true_type{});
    } else {
      pass_run(pass, std::false_type{});
    }
  }
}

// Partial dWl (and, in the blocks of the first kw tile, partial dbl) of
// edge range s: part_w[s][k][c] = sum_e bf16(h2[e, k]) * bf16(dpre[e, c])
// and part_b[s][c] = sum_e dpre[e, c] with dpre in fp32. Block (kt, ct, s)
// owns 128 rows of dWl (64 per consumer warpgroup) by 256 columns and
// walks its edges in 64-deep slabs: warp 8 loads h2 [64 e][128 k], g and
// the senders by TMA; warps 9-11 gather x[senders] (cp.async); the
// consumers form dpre [64 e][256 c] while the previous slab's products
// run, then issue wgmma m64n256k16 with both operands edge-major
// (MN-major descriptors). tm_h2: h2b, 64 x 64 boxes in the 128-byte
// swizzle; tm_g: g [M, out] fp32, out x 64 boxes; tm_s: senders, 64-long
// boxes.
__global__ void __launch_bounds__(NT, 1)
dw_kernel(const __grid_constant__ CUtensorMap tm_h2,
          const __grid_constant__ CUtensorMap tm_g,
          const __grid_constant__ CUtensorMap tm_s,
          const float* __restrict__ x, float* __restrict__ part_w,
          float* __restrict__ part_b, int64_t M, int kw, int in_ch,
          int out_ch, int64_t per_split, DwPlan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 1023) & ~1023u) - raw_s;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw_s + pad;
  const Bars bar{base + p.bar_off};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = in_ch * out_ch;
  const int k0 = blockIdx.x * BM, c0 = blockIdx.y * 256;
  const int64_t e0 = (int64_t)blockIdx.z * per_split;
  const int64_t e1 = e0 + per_split < M ? e0 + per_split : M;
  const int nk = e1 > e0 ? (int)((e1 - e0 + 63) / 64) : 0;
  const int i0 = c0 / out_ch;
  const int ncmax = 256 / out_ch;
  const int nci = (C - c0 < 256 ? C - c0 : 256) / out_ch;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar.full(s), 1);
      mbar_init(bar.empty(s), 3);
    }
    for (int b = 0; b < XS; ++b) {
      mbar_init(bar.xfull(b), NF);
      mbar_init(bar.xempty(b), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    regs_dec<56>();
    if (warp == 8) {
      if (lane != 0) return;
      const uint32_t bytes = 16384 + 64 * out_ch * 4 + 64 * 8;
      for (int n = 0; n < nk; ++n) {
        const int s = n % p.stages;
        const uint32_t st = base + s * p.stage_bytes;
        const int eb = (int)(e0 + (int64_t)n * 64);
        mbar_wait(bar.empty(s), ((n / p.stages) & 1) ^ 1);
        mbar_expect_tx(bar.full(s), bytes);
        tma_load_2d(st, &tm_h2, bar.full(s), k0, eb);
        tma_load_2d(st + 8192, &tm_h2, bar.full(s), k0 + 64, eb);
        tma_load_2d(st + p.g_off, &tm_g, bar.full(s), 0, eb);
        tma_load_1d(st + p.s_off, &tm_s, bar.full(s), eb);
      }
      return;
    }
    // loaders: x[senders[e], i0 + c] of each slab, for its channels
    const int ft = tid - 9 * 32;
    for (int n = 0; n < nk; ++n) {
      const int s = n % p.stages, b = n % XS;
      mbar_wait(bar.full(s), (n / p.stages) & 1);
      mbar_wait(bar.xempty(b), ((n / XS) & 1) ^ 1);
      const int64_t* sn =
          reinterpret_cast<const int64_t*>(smem + s * p.stage_bytes + p.s_off);
      const uint32_t dst = base + p.x_off + b * p.x_bytes;
      for (int q = ft; q < 64 * nci; q += NF) {
        const int r = q / nci, c = q - r * nci;
        cp4(dst + (r * ncmax + c) * 4, x + sn[r] * in_ch + i0 + c);
      }
      cp_arrive(bar.xfull(b));   // once this thread's copies have landed
      bar_sync(BAR_LOAD, NF);
      if (ft == 0) mbar_arrive(bar.empty(s));
    }
    cp_commit();   // every copy issued, before the thread leaves
    cp_wait<0>();
    return;
  }

  // ---- consumers: warpgroup wg owns dWl rows k0 + 64 wg .. + 63; thread
  // tid forms the 8 columns cl .. cl + 7 (one channel) of rows
  // tid / 32 + 8 j of each dpre tile
  regs_inc<224>();
  const int wg = warp >> 2;
  const bool leader = (tid & 127) == 0;
  const int cl = (tid & 31) * 8, rg = tid >> 5;
  // a thread past C forms zeros from column 0's operands
  const float live = c0 + cl < C ? 1.f : 0.f;
  const int ci = live != 0.f ? cl / out_ch : 0;
  const int o = live != 0.f ? cl - ci * out_ch : 0;
  const uint32_t slot0 = base + p.slot_off + (cl >> 6) * 8192 +
                         off_sw128(rg, (cl & 63) >> 3);
  float dsum[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) dsum[v] = 0.f;
  float acc[128];
#pragma unroll
  for (int q = 0; q < 128; ++q) acc[q] = 0.f;
  pin(acc);
  // dpre rows of slab n into slot n % DW_SLOTS; DBL: also sum them in fp32
  auto form = [&](int n, auto dbl_c) {
    constexpr bool DBL = decltype(dbl_c)::value;
    const float* gt = reinterpret_cast<const float*>(
        smem + (n % p.stages) * p.stage_bytes + p.g_off);
    const float* xg =
        reinterpret_cast<const float*>(smem + p.x_off + (n % XS) * p.x_bytes);
    const uint32_t dst = slot0 + (n % DW_SLOTS) * DW_SLOT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = rg + 8 * j;
      const float xv =
          __bfloat162float(__float2bfloat16_rn(xg[r * ncmax + ci])) * live;
      const float4 g0 = *reinterpret_cast<const float4*>(gt + r * out_ch + o);
      const float4 g1 = *reinterpret_cast<const float4*>(gt + r * out_ch + o + 4);
      float v8[8];
      v8[0] = xv * g0.x; v8[1] = xv * g0.y; v8[2] = xv * g0.z;
      v8[3] = xv * g0.w; v8[4] = xv * g1.x; v8[5] = xv * g1.y;
      v8[6] = xv * g1.z; v8[7] = xv * g1.w;
      if constexpr (DBL) {
#pragma unroll
        for (int v = 0; v < 8; ++v) dsum[v] += v8[v];
      }
      st_shared_v4(dst + j * 8 * 128, pack_bf16(v8[0], v8[1]),
                   pack_bf16(v8[2], v8[3]), pack_bf16(v8[4], v8[5]),
                   pack_bf16(v8[6], v8[7]));
    }
  };
  for (int n = 0; n < nk; ++n) {
    const int s = n % p.stages;
    mbar_wait(bar.full(s), (n / p.stages) & 1);
    mbar_wait(bar.xfull(n % XS), (n / XS) & 1);
    // slot n % 3's last reader, three slabs back, is done in both
    // warpgroups: each passed the barrier of slab n - 1 after waiting for
    // its products of slab n - 3
    if (blockIdx.x == 0) {
      form(n, std::true_type{});
    } else {
      form(n, std::false_type{});
    }
    fence_proxy_async();   // generic stores, then the wgmma reads
    bar_sync(BAR_CONS, NC);
    if (tid == 0) mbar_arrive(bar.xempty(n % XS));
    const uint32_t a = base + s * p.stage_bytes + wg * 8192;
    const uint32_t b = base + p.slot_off + (n % DW_SLOTS) * DW_SLOT;
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_64x256_tt(acc, desc_mn128(a + 2048 * k, 8192),
                      desc_mn128(b + 2048 * k, 8192),
                      (n > 0 || k > 0) ? 1 : 0);
    }
    wg_commit();
    wg_wait<1>();
    if (leader && n > 0) mbar_arrive(bar.empty((n - 1) % p.stages));
  }
  wg_wait<0>();
  float* out = part_w + (int64_t)blockIdx.z * kw * C;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int k = k0 + wg * 64 + (warp & 3) * 16 + (lane >> 2) + hi * 8;
    if (k >= kw) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = c0 + j * 8 + (lane & 3) * 2;
      if (col < C) {
        *reinterpret_cast<float2*>(out + (int64_t)k * C + col) =
            make_float2(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
      }
    }
  }
  if (blockIdx.x == 0) {   // the eight row groups of each column, in order
    float* red = reinterpret_cast<float*>(smem + p.red_off);
#pragma unroll
    for (int v = 0; v < 8; ++v) red[rg * 256 + cl + v] = dsum[v];
    bar_sync(BAR_CONS, NC);
    if (c0 + tid < C) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) t += red[q * 256 + tid];
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

// cuTensorMapEncodeTiled, from the driver through the runtime: the
// library links no driver library of its own.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// A row-major [rows, cols] tensor map with [box_rows, box_cols] boxes;
// what lies outside the tensor reads as zeros.
// rank 1 reads only cols and box_cols.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type,
                int elem_bytes, const void* ptr, int rank, uint64_t rows,
                uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                bool swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), dims,
             strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One tensor map of launch_tc and what it was last encoded from: a call
// that passes a slot the tensor of the call before (the steady state of a
// training loop) reuses its map and skips the encoder.
struct MapSlot {
  const void* ptr = nullptr;
  uint64_t rows = 0, cols = 0;
  uint32_t box_rows = 0, box_cols = 0;
  CUtensorMap map;
};

bool slot_map(MapSlot& slot, EncodeTiled enc, CUtensorMapDataType type,
              int elem_bytes, const void* ptr, int rank, uint64_t rows,
              uint64_t cols, uint32_t box_rows, uint32_t box_cols,
              bool swizzle) {
  if (slot.ptr == ptr && slot.rows == rows && slot.cols == cols &&
      slot.box_rows == box_rows && slot.box_cols == box_cols) {
    return true;
  }
  slot.ptr = nullptr;
  if (!tensor_map(enc, &slot.map, type, elem_bytes, ptr, rank, rows, cols,
                  box_rows, box_cols, swizzle)) {
    return false;
  }
  slot.ptr = ptr;
  slot.rows = rows;
  slot.cols = cols;
  slot.box_rows = box_rows;
  slot.box_cols = box_cols;
  return true;
}

int launch_tc(const __nv_bfloat16* h2b, const __nv_bfloat16* wlt,
              const __nv_bfloat16* wlb, const float* x, const int64_t* senders,
              const float* g, float* dx_src, float* dh2, float* dwl,
              float* dbl, float* part_w, float* part_b, int64_t M, int kw,
              int in_ch, int out_ch, int splits, cudaStream_t stream) {
  const int C = in_ch * out_ch;
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // h2 (dx_dh's boxes), Wl^T, Wl, h2 (dw's boxes), g, senders
  thread_local MapSlot tm[6];
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!slot_map(tm[0], enc, BF, 2, h2b, 2, M, kw, tc::BM, 64, true) ||
      !slot_map(tm[1], enc, BF, 2, wlt, 2, C, kw, tc::BN, 64, true) ||
      !slot_map(tm[2], enc, BF, 2, wlb, 2, kw, C, tc::BN, 64, true) ||
      !slot_map(tm[3], enc, BF, 2, h2b, 2, M, kw, 64, 64, true) ||
      !slot_map(tm[4], enc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g, 2, M,
                out_ch, 64, out_ch, false) ||
      !slot_map(tm[5], enc, CU_TENSOR_MAP_DATA_TYPE_INT64, 8, senders, 1, 1,
                M, 1, 64, false)) {
    return (int)cudaErrorInvalidValue;
  }

  const tc::DxDhPlan p1 = tc::plan_dx_dh(kw, in_ch, out_ch);
  const tc::DwPlan p2 = tc::plan_dw(out_ch);
  if (!tc::plan_ok(p1) || p2.stages < 2) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> ready1{0}, ready2{0};
  cudaError_t err = smem_once(reinterpret_cast<const void*>(tc::dx_dh_kernel),
                              tc::SMEM_MAX, ready1);
  if (err != cudaSuccess) return (int)err;
  err = smem_once(reinterpret_cast<const void*>(tc::dw_kernel), tc::SMEM_MAX,
                  ready2);
  if (err != cudaSuccess) return (int)err;
  tc::dx_dh_kernel<<<(unsigned)((M + tc::BM - 1) / tc::BM), tc::NT, p1.smem,
                     stream>>>(tm[0].map, tm[1].map, tm[2].map, x, senders,
                               g, dx_src, dh2, M, kw, in_ch, out_ch, p1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // whole 64-edge slabs a split, so that only the last one is ragged
  const int64_t per_split = ((M + splits - 1) / splits + 63) / 64 * 64;
  const dim3 wgrid((unsigned)((kw + tc::BM - 1) / tc::BM),
                   (unsigned)((C + 255) / 256), (unsigned)splits);
  tc::dw_kernel<<<wgrid, tc::NT, p2.smem, stream>>>(
      tm[3].map, tm[4].map, tm[5].map, x, part_w, part_b, M, kw, in_ch,
      out_ch, per_split, p2);
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
// tensor (senders too: TMA reads it) 16-byte aligned, M < 2^31. dx_src
// [M, in_ch], dh2, dWl and dbl are written (nothing needs zeroing);
// part_w [splits, kw, C] and part_b [splits, C] are scratch. Returns a
// cudaError_t.
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
      C % tc::BN != 0 || in_ch > tc::MAX_IN || splits < 1 ||
      M >= (int64_t(1) << 31)) {
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
