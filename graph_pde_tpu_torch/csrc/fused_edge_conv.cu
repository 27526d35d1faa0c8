// Fused edge messages, forward (K1).
//
// Replaces the Pallas forward of graph_pde_tpu/ops/pallas_edge_conv.py:
// _fwd_kernel_omj (the default form), _fwd_kernel_res and _fwd_kernel,
// one function in three TPU layouts. Per edge e it computes
//
//   h1 = relu(attr[e] @ W0 + b0)            [kw1]
//   h2 = relu(h1 @ W1 + b1)                  [kw2]
//   K  = h2 @ Wl + bl                        [in * 64], column c = i*64 + o
//   msg[e, o] = sum_i x[senders[e], i] * K[i*64 + o]
//
// and writes only msg [E, 64]: K never reaches device memory.
//
// What bounds it on an H100: operations. At the GKN shapes (kw1=128,
// kw2=256, in=64) an edge costs 2*(6*128 + 128*256 + 256*4096 + 4096)
// ~= 2.17 MFLOP against ~0.4 KB of input and output, far above the
// card's ops:byte balance. In bf16 mode the products' operands are
// bf16, so their bound is the bf16 tensor cores' (989 TFLOP/s); in
// float32 it is the SIMT units' (67 TFLOP/s: TF32 would break the 1e-4
// tolerance).
//
// Three forms, picked by the caller by shape and compute dtype
// (ops/fused_edge_conv.py k1_form):
//
// The tensor-core form ('tc': bf16 on the single-launch shapes with kw1
// <= 128) runs the two large products on wgmma; see its note below.
//
// The SIMT form ('simt': float32, and bf16 single-launch shapes the tc
// form does not take): a cluster of G blocks of 256 threads owns a tile
// of 128 edges, rank r of it the input-channel pairs [r * per, min(in /
// 2, (r + 1) * per)). Each block computes the whole h2 tile, which stays
// in its shared memory (k-major, up to 128 KB), so every K column tile
// is a [128 x kw2] x [kw2 x 128] product whose A operand never leaves
// the SM. Wl is streamed from L2 in [16 x 128] slabs, double-buffered
// through shared memory with the next slab fetched into registers while
// the current one is consumed. Each thread keeps an 8x8 register tile of
// K (64 FMAs per 4 shared-memory vector loads) and folds it straight
// into its 8x4 message accumulators: a 128-column tile is exactly the
// columns of two input channels i, i+1. It takes two small layers with
// kw2 % 128 == 0, out_channels == 64 and an h2 tile that fits shared
// memory (the GKN kappas, the multipole models' kw <= 256 mid levels).
// At 147-213 KB of shared memory a block runs one to an SM and walks
// its pairs in sequence, so a call of few tiles (the multipole levels:
// 6 to 38 tiles on 132 SMs) would take one block's latency whatever
// its edge count; the caller picks G (ops/fused_edge_conv.py
// k1_simt_groups) from the tiles and the clusters the card keeps
// resident, G = 1 where the tiles fill the card. With G > 1 each rank
// leaves its [128 x 64] partial messages in its own shared memory (over
// the h2 tile, whose last use is over), and after a cluster barrier
// rank r sums rows [r * 128 / G, (r + 1) * 128 / G) of the G partials
// through distributed shared memory, in rank order 0 .. G-1, and
// writes them: no partial buffer in device memory, no second launch,
// bit-repeatable. A second cluster barrier keeps every block resident
// until the others have read its partials. With G == 1 the block
// writes its messages directly, as a plain launch.
//
// The general form ('general': every other shape the JAX gate admits,
// wider or more small layers, other widths), at the end of this file,
// keeps the small activations in a device scratch buffer and streams
// them; K stays on chip there too.
//
// ROUND_BF16 mirrors compute_dtype='bfloat16' of the JAX kernel: GEMM
// operands (attr, W0, h1, W1, h2, Wl, x) are rounded to bf16, products
// accumulate in fp32, biases stay fp32, and each K*x product is rounded
// to bf16 before the sum over i, as the JAX o-major body does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <type_traits>

#include "sm90_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TE = 128;       // edges per block
constexpr int BN = 128;       // K columns per tile (two input channels)
constexpr int BK = 16;        // depth of one staged B slab
constexpr int THREADS = 256;
constexpr int OUT = 64;       // out_channels this kernel takes
constexpr int MAX_ADIM = 16;  // edge attribute width bound
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int MAX_CLUSTER = 16;   // blocks a SIMT cluster (non-portable > 8)

// Raises a kernel's dynamic shared memory bound to `bytes` (and, with
// `wide_clusters`, allows clusters above the portable 8 blocks) once
// for each device: `done` is the kernel's own set of devices already
// raised (bit d for device ordinal d), so a launch makes no attribute
// call.
cudaError_t smem_once(const void* kernel, int bytes,
                      std::atomic<uint64_t>& done,
                      bool wide_clusters = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && wide_clusters) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
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

// Row (edge) and column of register-tile element (r, j) of this thread.
__device__ __forceinline__ int tile_row(int ty, int r) {
  return (r < 4) ? ty * 4 + r : 64 + ty * 4 + (r - 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// c[r][j] += sum_kk as[kk][row(r)] * bs[kk][col(j)] over one staged slab:
// as is k-major [BK][TE], bs is [BK][BN], both in shared memory.
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

// c[r][j] += sum_k At[k][row(r)] * B[k][n0 + col(j)] over k < K.
// At: shared, k-major [K][TE]. B: global row-major with leading dim ldb.
// Bs: shared staging, 2 x [BK][BN]. K % BK == 0. Ends with a barrier.
template <bool RB>
__device__ __forceinline__ void tile_gemm(const float* __restrict__ At, int K,
                                          const float* __restrict__ B,
                                          int ldb, int n0,
                                          float* __restrict__ Bs,
                                          float (&c)[8][8]) {
  const int tid = threadIdx.x;
  const int lr = tid >> 4;          // staged slab row this thread loads
  const int lc = (tid & 15) * 8;    // and its first column
  const int nk = K / BK;
  float4 st0, st1;

  auto fetch = [&](int kt) {
    const float* src = B + (size_t)(kt * BK + lr) * ldb + n0 + lc;
    st0 = __ldg(reinterpret_cast<const float4*>(src));
    st1 = __ldg(reinterpret_cast<const float4*>(src + 4));
  };
  auto stash = [&](int buf) {
    float* dst = Bs + buf * (BK * BN) + lr * BN + lc;
    dst[0] = rnd<RB>(st0.x); dst[1] = rnd<RB>(st0.y);
    dst[2] = rnd<RB>(st0.z); dst[3] = rnd<RB>(st0.w);
    dst[4] = rnd<RB>(st1.x); dst[5] = rnd<RB>(st1.y);
    dst[6] = rnd<RB>(st1.z); dst[7] = rnd<RB>(st1.w);
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);
    slab_fma(At + (size_t)kt * BK * TE, Bs + (kt & 1) * (BK * BN), c);
    if (kt + 1 < nk) stash((kt + 1) & 1);
    __syncthreads();
  }
}

// v = the eight floats at p (16-byte aligned) if ok, else zeros.
__device__ __forceinline__ void ld8_or_zero(bool ok, const float* p,
                                            float (&v)[8]) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (ok) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The same product with both operands streamed from global memory and
// every bound checked: c[r][j] += sum_k A[m0 + row(r)][k] * B[k][col(j)]
// over k < K, with A row-major [M][K] and B row-major with leading dim
// ldb. Tile column bc + q of this thread's B loads (bc = (tid & 15) * 8)
// is B column boff[q], or zero where boff[q] < 0; rows >= M and k >= K
// read as zero. As: shared 2 x [BK][TE] (k-major), Bs: shared
// 2 x [BK][BN]. Ends with a barrier. VEC: K % 8 == 0, A and B 16-byte
// aligned, ldb % 4 == 0, and boff[q] == boff[0] + q (boff[0] % 4 == 0)
// or every boff[q] < 0, so each thread's eight operands of A and of B
// are two float4 loads.
template <bool RB, bool VEC>
__device__ __forceinline__ void tile_gemm_streamed(
    const float* __restrict__ A, int64_t M, int K, int64_t m0,
    const float* __restrict__ B, int64_t ldb, const int (&boff)[8],
    float* __restrict__ As, float* __restrict__ Bs, float (&c)[8][8]) {
  const int tid = threadIdx.x;
  const int ar = tid >> 1, ak = (tid & 1) * 8;   // A: row, first k
  const int br = tid >> 4, bc = (tid & 15) * 8;  // B: k row, first column
  const bool a_live = m0 + ar < M;
  const float* a_row = A + (a_live ? (m0 + ar) * (int64_t)K : 0);
  const int nk = (K + BK - 1) / BK;
  float sa[8], sb[8];

  auto fetch = [&](int kt) {
    const int k0 = kt * BK;
    const int kb = k0 + br;
    if constexpr (VEC) {
      const bool a_ok = a_live && k0 + ak < K;
      const bool b_ok = kb < K && boff[0] >= 0;
      ld8_or_zero(a_ok, a_ok ? a_row + k0 + ak : A, sa);
      ld8_or_zero(b_ok, b_ok ? B + kb * ldb + boff[0] : B, sb);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = k0 + ak + q;
        sa[q] = (a_live && k < K) ? __ldg(a_row + k) : 0.f;
        sb[q] = (kb < K && boff[q] >= 0) ? __ldg(B + kb * ldb + boff[q])
                                         : 0.f;
      }
    }
  };
  auto stash = [&](int buf) {
    float* as = As + buf * (BK * TE);
    float* bs = Bs + buf * (BK * BN) + br * BN + bc;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      as[(ak + q) * TE + ar] = rnd<RB>(sa[q]);
      bs[q] = rnd<RB>(sb[q]);
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

// Dynamic shared memory of a SIMT block whose rank gathers `per`
// channel pairs: h2t, the h1t / xt region and the B staging slabs.
size_t simt_smem(int kw1, int kw2, int per) {
  const int wide = kw1 > 2 * per ? kw1 : 2 * per;
  return sizeof(float) * ((size_t)kw2 * TE + (size_t)wide * TE + 2 * BK * BN);
}

// Block b is rank b % G of the cluster that owns edge tile b / G (the
// grid is one-dimensional, G blocks a tile, so a tile count past 65,535
// launches as well).
template <bool RB>
__global__ void __launch_bounds__(THREADS, 1)
edge_messages_kernel(const float* __restrict__ x,
                     const int64_t* __restrict__ senders,
                     const float* __restrict__ attr,
                     const float* __restrict__ w0, const float* __restrict__ b0,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ wl, const float* __restrict__ bl,
                     float* __restrict__ msg, int64_t E, int in_ch,
                     int a_dim, int kw1, int kw2, int G, int per) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wide = kw1 > 2 * per ? kw1 : 2 * per;
  float* h2t = smem;                                   // [kw2][TE]
  float* reg = h2t + (size_t)kw2 * TE;  // h1t [kw1][TE], then xt [nch][TE]
  float* bs = reg + (size_t)wide * TE;                 // 2 x [BK][BN]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int rank = (int)(blockIdx.x % (unsigned)G);
  const int64_t e0 = (int64_t)(blockIdx.x / (unsigned)G) * TE;
  const int C = in_ch * OUT;
  const int i_lo = 2 * rank * per;                     // this rank's channels
  const int i_hi = in_ch - i_lo < 2 * per ? in_ch : i_lo + 2 * per;
  const int nch = i_hi - i_lo;

  // 1. h1t[j][e] = relu(attr[e] . W0[:, j] + b0[j])
  {
    const int e = tid & (TE - 1);
    const bool ok = e0 + e < E;
    float a[MAX_ADIM];
#pragma unroll
    for (int q = 0; q < MAX_ADIM; ++q) {
      a[q] = (ok && q < a_dim) ? rnd<RB>(attr[(e0 + e) * a_dim + q]) : 0.f;
    }
    for (int j = tid >> 7; j < kw1; j += 2) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_ADIM; ++q) {
        if (q < a_dim) s = fmaf(a[q], rnd<RB>(__ldg(w0 + q * kw1 + j)), s);
      }
      reg[j * TE + e] = rnd<RB>(fmaxf(s + __ldg(b0 + j), 0.f));
    }
  }
  __syncthreads();

  // 2. h2t[j][e] = relu(h1 @ W1 + b1), BN columns per pass
  for (int n0 = 0; n0 < kw2; n0 += BN) {
    float c[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[r][j] = 0.f;
    }
    tile_gemm<RB>(reg, kw1, w1, kw2, n0, bs, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_col(tx, j);
      const float bias = __ldg(b1 + col);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        h2t[col * TE + tile_row(ty, r)] = rnd<RB>(fmaxf(c[r][j] + bias, 0.f));
      }
    }
  }
  // tile_gemm ended with a barrier: nobody reads h1t any more.

  // 3. xt[i - i_lo][e] = x[senders[e], i] for this rank's channels (the
  // gather, folded in)
  for (int idx = tid; idx < TE * nch; idx += THREADS) {
    const int e = idx / nch;
    const int i = idx - e * nch;
    float v = 0.f;
    if (e0 + e < E) {
      v = rnd<RB>(__ldg(x + senders[e0 + e] * in_ch + i_lo + i));
    }
    reg[i * TE + e] = v;
  }
  __syncthreads();

  // 4. msg[e, o] = sum_i x[e, i] * (h2 @ Wl + bl)[e, i*64 + o] over this
  // rank's channels
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  for (int i0 = i_lo; i0 < i_hi; i0 += 2) {
    const int n0 = i0 * OUT;
    const float* xt = reg + (size_t)(i0 - i_lo) * TE;
    float c[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[r][j] = 0.f;
    }
    tile_gemm<RB>(h2t, kw2, wl, C, n0, bs, c);
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[j] = __ldg(bl + n0 + tile_col(tx, j));
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = tile_row(ty, r);
      const float xa = xt[row];
      const float xb = xt[TE + row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ka = c[r][j] + bias[j];
        const float kb = c[r][j + 4] + bias[j + 4];
        if constexpr (RB) {
          acc[r][j] += rnd<RB>(ka * xa);
          acc[r][j] += rnd<RB>(kb * xb);
        } else {
          acc[r][j] = fmaf(ka, xa, acc[r][j]);
          acc[r][j] = fmaf(kb, xb, acc[r][j]);
        }
      }
    }
  }

  // 5. G == 1: store the valid rows
  if (G == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t e = e0 + tile_row(ty, r);
      if (e < E) {
        *reinterpret_cast<float4*>(msg + e * OUT + tx * 4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    return;
  }

  // 5'. G > 1: this rank's partials part[row][o] over the h2 tile (its
  // last read was the last tile_gemm, which ended with a barrier); every
  // block of the cluster reaches both barriers, whatever rows are valid
  float4* part = reinterpret_cast<float4*>(h2t);      // [TE][OUT / 4]
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    part[tile_row(ty, r) * (OUT / 4) + tx] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int lo = rank * TE / G, hi = (rank + 1) * TE / G;
  for (int idx = tid; idx < (hi - lo) * (OUT / 4); idx += THREADS) {
    const int row = lo + idx / (OUT / 4);
    const int q4 = idx % (OUT / 4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < G; ++q) {
      const float4 v =
          cluster.map_shared_rank(part, (unsigned)q)[row * (OUT / 4) + q4];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (e0 + row < E) {
      reinterpret_cast<float4*>(msg + (e0 + row) * OUT)[q4] = s;
    }
  }
  cluster.sync();
}

template <bool RB>
cudaError_t simt_attributes() {
  static std::atomic<uint64_t> ready{0};
  return smem_once(reinterpret_cast<const void*>(edge_messages_kernel<RB>),
                   MAX_SMEM, ready, true);
}

template <bool RB>
int launch(const float* x, const int64_t* senders, const float* attr,
           const float* w0, const float* b0, const float* w1, const float* b1,
           const float* wl, const float* bl, float* msg, int64_t E, int in_ch,
           int a_dim, int kw1, int kw2, int G, int per,
           cudaStream_t stream) {
  cudaError_t err = simt_attributes<RB>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = simt_smem(kw1, kw2, per);
  const int64_t blocks = (E + TE - 1) / TE * G;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (G == 1) {
    edge_messages_kernel<RB><<<(unsigned)blocks, THREADS, smem, stream>>>(
        x, senders, attr, w0, b0, w1, b1, wl, bl, msg, E, in_ch, a_dim, kw1,
        kw2, G, per);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr_c[1];
  attr_c[0].id = cudaLaunchAttributeClusterDimension;
  attr_c[0].val.clusterDim.x = (unsigned)G;
  attr_c[0].val.clusterDim.y = 1;
  attr_c[0].val.clusterDim.z = 1;
  cfg.attrs = attr_c;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, edge_messages_kernel<RB>, x, senders, attr,
                           w0, b0, w1, b1, wl, bl, msg, E, in_ch, a_dim, kw1,
                           kw2, G, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of g SIMT blocks (g = 1 .. max_g) the current device keeps
// resident at once, each rank gathering ceil((in / 2) / g) pairs.
template <bool RB>
int simt_clusters(int kw1, int kw2, int in_ch, int max_g, int* clusters) {
  cudaError_t err = simt_attributes<RB>();
  if (err != cudaSuccess) return (int)err;
  const int pairs = in_ch / 2;
  for (int g = 1; g <= max_g; ++g) {
    const int per = (pairs + g - 1) / g;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)g, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = simt_smem(kw1, kw2, per);
    cudaLaunchAttribute attr_c[1];
    attr_c[0].id = cudaLaunchAttributeClusterDimension;
    attr_c[0].val.clusterDim.x = (unsigned)g;
    attr_c[0].val.clusterDim.y = 1;
    attr_c[0].val.clusterDim.z = 1;
    cfg.attrs = attr_c;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters[g - 1],
                                         edge_messages_kernel<RB>, &cfg);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---- Tensor-core form: compute_dtype='bfloat16' on the single-launch
// shapes with kw1 <= 128 (the GKN kappas) ----
//
// Every product of the MLP runs on the bf16 tensor cores (wgmma, fp32
// accumulators); only attr @ W0 (a_dim <= 16, under 1 % of the
// operations) and the contraction stay on the CUDA cores. One block of
// two warpgroups owns a tile of BM = 128 edges, each warpgroup 64 of
// them. Shared memory (k1_smem): a four-stage cp.async ring of 8 KB
// stages, the bf16 h2 tile [128][kw2] as kw2 / 32 K-major slabs (the
// 64-byte swizzle wgmma reads, off_k32), and bf16(x[senders]) channel
// by channel [in][128]. At the GKN shape that is 115,200 bytes: two
// blocks share an SM.
//   1. h1 = relu(bf16(attr) @ bf16(W0) + b0) on the CUDA cores, each
//      thread computing exactly its own entries of the warpgroup's
//      wgmma A fragment, rounded to bf16 in registers (kw1 / 4 of them:
//      h1 never touches shared memory); the x gather, rounded, into
//      shared memory.
//   2. h2 = relu(h1 @ W1 + b1), 64 columns at a time: wgmma m64n64k16
//      with A from those registers and bf16 W1^T slabs [64 n][32 k] from
//      the ring; the epilogue writes bf16 h2 straight into its swizzled
//      slabs.
//   3. K = h2 @ Wl + bl, 64 columns (one input channel) at a time:
//      wgmma m64n64k16 on the resident h2 slabs and Wl^T slabs [64 n][32
//      k] from the ring. In the accumulator layout a thread holds whole
//      (row, o) entries of the channel, so the contraction is the
//      epilogue, in registers: msg[r][o] += bf16((K[r][i*64+o] + bl) *
//      x[r, i]), summed in fp32 in the order i = 0, 1, ...: no
//      shuffles, no atomics, a second launch is bit-identical.
// The ring keeps one stage's wgmma in flight while the next stage is
// issued (wgmma.wait_group 1) and two stages of loads ahead; each tile's
// epilogue waits for its last products. K never leaves the registers.
// Registers are bound to two blocks an SM (128 a thread): one block an
// SM without spills, or two-channel K tiles, measured slower (PERF.md).
// The caller makes the bf16 operands W1^T [kw2][kw1] and Wl^T [C][kw2]
// (rounded to nearest even, as bf16(W) in the JAX kernel) once per call.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;              // edges per block
constexpr int STAGES = 4;            // ring stages
constexpr int STAGE = 8192;          // bytes of a ring stage
constexpr int SLAB = BM * 64;        // bytes of a [128][32] bf16 slab
constexpr int SLAB64 = 64 * 64;      // bytes of a [64][32] bf16 slab
constexpr int MAX_KW1 = 128;         // h1 fragments held in registers
constexpr int KD = STAGE / (OUT * 2);  // k depth of a Wl^T ring stage
constexpr int SL = KD / 32;          // [64 n][32 k] slabs a Wl^T stage

constexpr size_t k1_smem(int kw2, int in_ch) {
  return 512 + (size_t)STAGES * STAGE + (size_t)kw2 * BM * 2 +
         (size_t)in_ch * BM * 2;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(256, 2)
k1_kernel(const float* __restrict__ x, const int64_t* __restrict__ senders,
          const float* __restrict__ attr, const float* __restrict__ w0,
          const float* __restrict__ b0, const bf16* __restrict__ w1t,
          const float* __restrict__ b1, const bf16* __restrict__ wlt,
          const float* __restrict__ bl, float* __restrict__ msg, int64_t E,
          int in_ch, int a_dim, int kw1, int kw2) {
  constexpr int NK1 = MAX_KW1 / 16;   // k16 steps of h1, at most
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 511) & ~511u) - raw_s;   // swizzle atoms
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw_s + pad;
  unsigned char* h2p = smem + STAGES * STAGE;
  const uint32_t h2s = ring + STAGES * STAGE;
  bf16* xs = reinterpret_cast<bf16*>(h2p + (size_t)kw2 * BM * 2);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int t4 = lane & 3;
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int64_t e0 = (int64_t)blockIdx.x * BM;

  // W1^T stages of step it = (64-column tile, 64-deep k stage): two
  // [64 n][32 k] slabs, zero beyond kw1
  const int nk16 = kw1 / 16;
  const int ns1 = (kw1 + 63) / 64;
  const int total1 = (kw2 / 64) * ns1;
  auto load1 = [&](int it) {
    if (it < total1) {
      const int t = it / ns1, s = it - t * ns1;
      const uint32_t sb = ring + (it % STAGES) * STAGE;
      const int r = tid >> 2, ch = tid & 3;   // one chunk a slab
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = s * 64 + q * 32 + ch * 8;
        const bool ok = k < kw1;
        cp16(sb + q * SLAB64 + off_k32(r, ch),
             ok ? w1t + (int64_t)(t * 64 + r) * kw1 + k : w1t, ok);
      }
    }
    cp_commit();
  };
  // Wl^T stages of step it = (input channel, KD-deep k stage): SL slabs
  // [64 n][32 k]
  const int ns = kw2 / KD;
  const int total2 = in_ch * ns;
  auto load2 = [&](int it) {
    if (it < total2) {
      const int t = it / ns, s = it - t * ns;
      const uint32_t sb = ring + (it % STAGES) * STAGE;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = tid + q * 256, sl = idx / (OUT * 4);
        const int r = (idx >> 2) % OUT, ch = idx & 3;
        cp16(sb + sl * OUT * 64 + off_k32(r, ch),
             wlt + (int64_t)(t * OUT + r) * kw2 + s * KD + sl * 32 + ch * 8,
             true);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) load1(s);

  // 1. h1 in the A fragment layout: rows wrow and wrow + 8, columns
  // 16 kb + 2 t4 + {0, 1} (registers 0, 1) and + 8 (registers 2, 3)
  uint32_t h1f[NK1][4];
  {
    float a[2][MAX_ADIM];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int64_t e = e0 + wrow + hi * 8;
#pragma unroll
      for (int q = 0; q < MAX_ADIM; ++q) {
        a[hi][q] = (e < E && q < a_dim) ? bf16r(__ldg(attr + e * a_dim + q))
                                        : 0.f;
      }
    }
#pragma unroll
    for (int kb = 0; kb < NK1; ++kb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = kb * 16 + half * 8 + t4 * 2;
        float v[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        if (kb < nk16) {
#pragma unroll
          for (int q = 0; q < MAX_ADIM; ++q) {
            if (q < a_dim) {
              const float2 w = __ldg(
                  reinterpret_cast<const float2*>(w0 + q * kw1 + c));
              const float w_0 = bf16r(w.x), w_1 = bf16r(w.y);
#pragma unroll
              for (int hi = 0; hi < 2; ++hi) {
                v[hi][0] = fmaf(a[hi][q], w_0, v[hi][0]);
                v[hi][1] = fmaf(a[hi][q], w_1, v[hi][1]);
              }
            }
          }
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b0 + c));
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            v[hi][0] = fmaxf(v[hi][0] + bb.x, 0.f);
            v[hi][1] = fmaxf(v[hi][1] + bb.y, 0.f);
          }
        }
        h1f[kb][half * 2] = pack_bf16(v[0][0], v[0][1]);
        h1f[kb][half * 2 + 1] = pack_bf16(v[1][0], v[1][1]);
      }
    }
  }
  // the x gather: row r of the tile, every channel
  {
    const int r = tid & (BM - 1);
    const int64_t e = e0 + r;
    const bool ok = e < E;
    const int64_t src = ok ? senders[e] * in_ch : 0;
    for (int i = tid >> 7; i < in_ch; i += 2) {
      xs[i * BM + r] = __float2bfloat16_rn(ok ? __ldg(x + src + i) : 0.f);
    }
  }

  // 2. h2 = relu(h1 @ W1 + b1), one 64-column tile at a time. The
  // stages of a tile are unrolled, so every k16 step names its A
  // fragment at compile time.
  {
    float d[32];
    for (int t = 0; t < kw2 / 64; ++t) {
#pragma unroll
      for (int s = 0; s < NK1 / 4; ++s) {
        if (s >= ns1) break;   // block-uniform
        const int it = t * ns1 + s;
        cp_wait<STAGES - 3>();
        fence_proxy_async();
        __syncthreads();
        load1(it + STAGES - 2);
        const uint32_t sb = ring + (it % STAGES) * STAGE;
        wg_fence();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kb = s * 4 + u;
          if (kb < nk16) {
            wgmma_64x64_rs(d, h1f[kb],
                           wg_desc(sb + (u >> 1) * SLAB64) + (u & 1) * 2,
                           kb != 0);
          }
        }
        wg_commit();
        if (s != ns1 - 1) wg_wait<1>();
      }
      wg_wait<0>();
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = wrow + hi * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = t * 64 + j * 8 + t4 * 2;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
          const uint32_t v =
              pack_bf16(fmaxf(d[4 * j + 2 * hi] + bb.x, 0.f),
                        fmaxf(d[4 * j + 2 * hi + 1] + bb.y, 0.f));
          *reinterpret_cast<uint32_t*>(h2p + (c >> 5) * SLAB +
                                       off_k32(row, (c & 31) >> 3) +
                                       (c & 7) * 2) = v;
        }
      }
    }
  }

  // 3. K = h2 @ Wl + bl, one input channel (64 columns) at a time,
  // folded into msg
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  {
    float d[32];
    // the other warpgroup's last phase-2 wgmma may still read the ring
    // stages that the first loads below overwrite
    __syncthreads();
#pragma unroll
    for (int s = 0; s < STAGES - 2; ++s) load2(s);
    for (int it = 0; it < total2; ++it) {
      cp_wait<STAGES - 3>();
      fence_proxy_async();
      __syncthreads();
      load2(it + STAGES - 2);
      const int t = it / ns, s = it - t * ns;
      const uint32_t sb = ring + (it % STAGES) * STAGE;
      wg_fence();
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        const uint64_t da =
            wg_desc(h2s + (s * SL + sl) * SLAB + wg * 64 * 64);
        const uint64_t db = wg_desc(sb + sl * OUT * 64);
        wgmma_64x64(d, da, db, (s | sl) != 0);
        wgmma_64x64(d, da + 2, db + 2, 1);
      }
      wg_commit();
      if (s != ns - 1) {
        wg_wait<1>();
        continue;
      }
      wg_wait<0>();
      const float x0 = __bfloat162float(xs[t * BM + wrow]);
      const float x1 = __bfloat162float(xs[t * BM + wrow + 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* k = d + 4 * j;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(
            bl + t * OUT + j * 8 + t4 * 2));
        acc[4 * j] += bf16r((k[0] + bb.x) * x0);
        acc[4 * j + 1] += bf16r((k[1] + bb.y) * x0);
        acc[4 * j + 2] += bf16r((k[2] + bb.x) * x1);
        acc[4 * j + 3] += bf16r((k[3] + bb.y) * x1);
      }
    }
  }

  // 4. store the valid rows
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int64_t e = e0 + wrow + hi * 8;
    if (e >= E) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(msg + e * OUT + j * 8 + t4 * 2) =
          make_float2(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
    }
  }
}

// the kernel's dynamic shared memory and carve-out for smem bytes
cudaError_t set_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k1_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

int launch(const float* x, const int64_t* senders, const float* attr,
           const float* w0, const float* b0, const bf16* w1t, const float* b1,
           const bf16* wlt, const float* bl, float* msg, int64_t E, int in_ch,
           int a_dim, int kw1, int kw2, cudaStream_t stream) {
  const size_t smem = k1_smem(kw2, in_ch);
  if (a_dim < 1 || a_dim > MAX_ADIM || kw1 < 16 || kw1 % 16 != 0 ||
      kw1 > MAX_KW1 || kw2 < 128 || kw2 % 128 != 0 || in_ch < 1 ||
      smem > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  k1_kernel<<<(unsigned)((E + BM - 1) / BM), 256, smem, stream>>>(
      x, senders, attr, w0, b0, w1t, b1, wlt, bl, msg, E, in_ch, a_dim, kw1,
      kw2);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- General form: every shape the JAX gate admits ----
//
// Any number of small layers (zero included), any widths, any in/out.
// Per chunk of edges (the Python wrapper loops over chunks):
//   dense_relu_kernel, once per small layer: h <- relu(h @ W + b), with
//     h in a device scratch buffer. These are the small activations,
//     never K.
//   last_contract_kernel: per tile of 128 edges and group of input
//     channels, streams h and Wl and folds each 128-column tile of K
//     into the messages (K never leaves the SM).
// A K tile holds P = 128 / ow input channels of ow output columns each,
// ow = out_ch rounded up to a power of two, at most 128 (above 128
// outputs, blockIdx.z picks the block's 128 outputs and P = 1).
//
// What bounds it: operations, on the fp32 SIMT units (or bf16-rounded
// operands, still fp32 FMAs). The multipole models' levels have few
// edges (16 to 3,066 at s = 1024), so a grid of one block per 128 edges
// would leave most of the 132 SMs idle. Block (m, g, z) owns 128 edges
// and the g-th group of `per` input channels, whole K tiles; the caller
// picks the number of groups G (ops/fused_edge_conv.py
// k1_general_groups) so that the grid fills the card twice over where
// the tiles allow, and G = 1 where the edge tiles alone do. Each thread
// keeps its 8 x 8 partial messages in its own slots of shared memory,
// so the registers hold only the K tile and two blocks share an SM. At
// the end the threads whose columns share an output meet there and are
// summed in a fixed order. With G > 1 each block writes its group's
// partial messages and sum_parts_kernel adds the G partials in the
// order g = 0, 1, ...: bit-repeatable, no atomics. With G == 1 the
// block writes the messages. Where K % 8 == 0 and out_ch % 8 == 0 (and
// h, Wl are 16-byte aligned: VEC) a thread's eight h and eight Wl
// operands of a slab are two float4 loads each.

template <bool RB>
__global__ void __launch_bounds__(THREADS)
dense_relu_kernel(const float* __restrict__ A, int64_t M, int K,
                  const float* __restrict__ W, const float* __restrict__ b,
                  int N, float* __restrict__ out) {
  __shared__ __align__(16) float as[2 * BK * TE];
  __shared__ __align__(16) float bs[2 * BK * BN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.x * TE;
  const int n0 = blockIdx.y * BN;
  int boff[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int col = n0 + tx * 8 + q;
    boff[q] = col < N ? col : -1;
  }
  float c[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[r][j] = 0.f;
  }
  tile_gemm_streamed<RB, false>(A, M, K, m0, W, N, boff, as, bs, c);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tile_col(tx, j);
    if (col >= N) continue;
    const float bias = __ldg(b + col);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t row = m0 + tile_row(ty, r);
      if (row < M) out[row * N + col] = fmaxf(c[r][j] + bias, 0.f);
    }
  }
}

// Partial slots of a thread: its 8 x 8 messages as 16 float4s, slot
// 2 * r + j / 4 of thread t at acc[slot * THREADS + t] (a warp's 32
// threads read 512 contiguous bytes).
constexpr int ACC_SLOTS = 16;
constexpr size_t kLastSmem =
    sizeof(float) * (2 * BK * TE + 2 * BK * BN) +
    sizeof(float4) * ACC_SLOTS * THREADS;   // as, bs, acc: 96 KB

// out[g][e][o] (out = msg where gridDim.y == 1): the messages of block
// (m, g, z)'s edges over input channels [g * per, (g + 1) * per) and
// outputs [128 z, 128 z + 128). per is a multiple of P (or >= in_ch).
template <bool RB, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
last_contract_kernel(const float* __restrict__ h, int64_t M, int K,
                     const float* __restrict__ wl,
                     const float* __restrict__ bl,
                     const float* __restrict__ x,
                     const int64_t* __restrict__ senders,
                     float* __restrict__ out, int in_ch, int out_ch,
                     int ow, int per) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);   // 2 x [BK][TE]
  float* bs = as + 2 * BK * TE;                  // 2 x [BK][BN]
  float4* acc = smem4 + (2 * BK * TE + 2 * BK * BN) / 4;
  __shared__ int64_t src[TE];        // x row offset of each edge, or -1

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.x * TE;
  const int i_lo = blockIdx.y * per;
  const int i_hi = in_ch - i_lo < per ? in_ch : i_lo + per;
  const int o0 = blockIdx.z * BN;
  const int P = BN / ow;
  const int64_t C = (int64_t)in_ch * out_ch;

  if (tid < TE) src[tid] = m0 + tid < M ? senders[m0 + tid] * in_ch : -1;
#pragma unroll
  for (int q = 0; q < ACC_SLOTS; ++q) {
    acc[q * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // src is read after tile_gemm_streamed's first barrier

  for (int i0 = i_lo; i0 < i_hi; i0 += P) {
    // tile column col is channel i0 + col / ow, output o0 + col % ow
    int boff[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = tx * 8 + q;
      const int i = i0 + col / ow, o = o0 + col % ow;
      boff[q] = (i < i_hi && o < out_ch) ? i * out_ch + o : -1;
    }
    float c[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[r][j] = 0.f;
    }
    tile_gemm_streamed<RB, VEC>(h, M, K, m0, wl, C, boff, as, bs, c);
    int ich[8];       // channel of column j, or -1 outside the shape
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tile_col(tx, j);
      const int i = i0 + col / ow, o = o0 + col % ow;
      const bool ok = i < i_hi && o < out_ch;
      ich[j] = ok ? i : -1;
      bias[j] = ok ? __ldg(bl + i * out_ch + o) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t s = src[tile_row(ty, r)];
      if (s < 0) continue;
#pragma unroll
      for (int jq = 0; jq < 2; ++jq) {
        float4* slot = acc + (r * 2 + jq) * THREADS + tid;
        const float4 a = *slot;
        float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = jq * 4 + jj;
          if (ich[j] < 0) continue;
          const float xv = rnd<RB>(__ldg(x + s + ich[j]));
          const float kv = c[r][j] + bias[j];
          if constexpr (RB) {
            v[jj] += rnd<RB>(kv * xv);
          } else {
            v[jj] = fmaf(kv, xv, v[jj]);
          }
        }
        *slot = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();

  // out[e, o] = sum_p acc(e, p * ow + o), p = 0, 1, ...: element (row,
  // col) of the block's tile is thread ((row % 64) / 4) * 16 + (col %
  // 64) / 4, r = (row / 64) * 4 + row % 4, j = (col / 64) * 4 + col % 4
  const float* accf = reinterpret_cast<const float*>(acc);
  float* dst = out + (int64_t)blockIdx.y * M * out_ch;
  for (int idx = tid; idx < TE * ow; idx += THREADS) {
    const int e = idx / ow, o = idx - e * ow;
    const int64_t row = m0 + e;
    if (row >= M || o0 + o >= out_ch) continue;
    const int t_row = ((e & 63) >> 2) * 16;
    const int r = (e >> 6) * 4 + (e & 3);
    float s = 0.f;
    for (int p = 0; p < P; ++p) {
      const int col = p * ow + o;
      const int t = t_row + ((col & 63) >> 2);
      s += accf[((r * 2 + (col >> 6)) * THREADS + t) * 4 + (col & 3)];
    }
    dst[row * out_ch + o0 + o] = s;
  }
}

// out[j] = sum_{g < G} part[g][j], in order of g.
__global__ void __launch_bounds__(THREADS)
sum_parts_kernel(const float* __restrict__ part, int G, int64_t n,
                 float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[(int64_t)g * n + j];
  out[j] = s;
}

template <bool RB>
int launch_dense_relu(const float* A, int64_t M, int K, const float* W,
                      const float* b, int N, float* out,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)((M + TE - 1) / TE),
                  (unsigned)((N + BN - 1) / BN));
  dense_relu_kernel<RB><<<grid, THREADS, 0, stream>>>(A, M, K, W, b, N, out);
  return (int)cudaGetLastError();
}

template <bool RB, bool VEC>
int launch_last_contract(const float* h, int64_t M, int K, const float* wl,
                         const float* bl, const float* x,
                         const int64_t* senders, float* msg, float* part,
                         int in_ch, int out_ch, int ow, int per,
                         cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = smem_once(
      reinterpret_cast<const void*>(last_contract_kernel<RB, VEC>),
      (int)kLastSmem, ready);
  if (err != cudaSuccess) return (int)err;
  const int groups = (in_ch + per - 1) / per;
  const dim3 grid((unsigned)((M + TE - 1) / TE), (unsigned)groups,
                  (unsigned)((out_ch + BN - 1) / BN));
  last_contract_kernel<RB, VEC><<<grid, THREADS, kLastSmem, stream>>>(
      h, M, K, wl, bl, x, senders, groups > 1 ? part : msg, in_ch, out_ch,
      ow, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const int64_t n = M * out_ch;
  sum_parts_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                     stream>>>(part, groups, n, msg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// SIMT form. Shape contract (checked by the Python wrapper):
// out_channels == 64, in_ch even, a_dim <= 16, kw1 % 16 == 0, kw2 % 128
// == 0, shared memory 4 * (128 * (kw2 + max(kw1, 2 * per)) + 4096) bytes
// <= 227 KB, every pointer 16-byte aligned and contiguous. Clusters of
// `groups` blocks (1 .. 16), each rank `per` of the in_ch / 2 channel
// pairs, the last rank the rest: 1 <= per <= in_ch / 2 and every rank
// non-empty, else cudaErrorInvalidValue. Returns a cudaError_t (a
// cluster the card cannot schedule fails the launch).
int gpde_edge_messages(const float* x, const int64_t* senders,
                       const float* attr, const float* w0, const float* b0,
                       const float* w1, const float* b1, const float* wl,
                       const float* bl, float* msg, int64_t E, int in_ch,
                       int a_dim, int kw1, int kw2, int groups, int per,
                       int round_bf16, void* stream) {
  const int pairs = in_ch / 2;
  if (in_ch % 2 != 0 || groups < 1 || groups > MAX_CLUSTER || per < 1 ||
      per > pairs || (int64_t)(groups - 1) * per >= pairs ||
      (int64_t)groups * per < pairs) {
    return (int)cudaErrorInvalidValue;
  }
  if (E == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (round_bf16) {
    return launch<true>(x, senders, attr, w0, b0, w1, b1, wl, bl, msg, E,
                        in_ch, a_dim, kw1, kw2, groups, per, s);
  }
  return launch<false>(x, senders, attr, w0, b0, w1, b1, wl, bl, msg, E,
                       in_ch, a_dim, kw1, kw2, groups, per, s);
}

// SIMT form: clusters[g - 1] = the clusters of g blocks (g = 1 ..
// max_g, max_g <= 16) that the current device keeps resident at once
// at (kw1, kw2, in_ch), as cudaOccupancyMaxActiveClusters reports them.
// Returns a cudaError_t.
int gpde_edge_messages_clusters(int kw1, int kw2, int in_ch, int round_bf16,
                                int max_g, int* clusters) {
  if (max_g < 1 || max_g > MAX_CLUSTER || in_ch < 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (round_bf16) return simt_clusters<true>(kw1, kw2, in_ch, max_g, clusters);
  return simt_clusters<false>(kw1, kw2, in_ch, max_g, clusters);
}

// Tensor-core form (compute_dtype='bfloat16'): w1t = W1^T [kw2][kw1] and
// wlt = Wl^T [in_ch * 64][kw2] in bf16 (rounded to nearest even by the
// caller), the rest fp32 as above; out_channels == 64, 1 <= a_dim <= 16,
// kw1 % 16 == 0 and kw1 <= 128, kw2 % 128 == 0, in_ch >= 1, and shared
// memory tc::k1_smem(kw2, in_ch) within the 227 KB of a block (refused with
// cudaErrorInvalidValue otherwise). Every tensor contiguous; w0, b0,
// w1t, b1, wlt and bl 16-byte aligned. Returns a cudaError_t.
int gpde_edge_messages_tc(const float* x, const int64_t* senders,
                          const float* attr, const float* w0,
                          const float* b0, const void* w1t, const float* b1,
                          const void* wlt, const float* bl, float* msg,
                          int64_t E, int in_ch, int a_dim, int kw1, int kw2,
                          void* stream) {
  if (E == 0) return 0;
  using B = const __nv_bfloat16*;
  return tc::launch(x, senders, attr, w0, b0, reinterpret_cast<B>(w1t), b1,
                    reinterpret_cast<B>(wlt), bl, msg, E, in_ch, a_dim, kw1,
                    kw2, reinterpret_cast<cudaStream_t>(stream));
}

// The tensor-core form's dynamic shared memory a block (*smem) and its
// resident blocks an SM (*blocks) at (kw2, in_ch), as the card reports
// them. Returns a cudaError_t.
int gpde_edge_messages_tc_occupancy(int kw2, int in_ch, int* smem,
                                    int* blocks) {
  *smem = (int)tc::k1_smem(kw2, in_ch);
  const cudaError_t err = tc::set_smem((size_t)*smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tc::k1_kernel, 256, (size_t)*smem);
}

// General form, one small layer: out [M, N] = relu(A [M, K] @ W [K, N]
// + b), all fp32 row-major contiguous. Returns a cudaError_t.
int gpde_dense_relu(const float* A, int64_t M, int K, const float* W,
                    const float* b, int N, float* out, int round_bf16,
                    void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (round_bf16) return launch_dense_relu<true>(A, M, K, W, b, N, out, s);
  return launch_dense_relu<false>(A, M, K, W, b, N, out, s);
}

// General form, last layer and contraction: msg [M, out_ch] from the
// last hidden activations h [M, K], Wl [K, in_ch * out_ch], bl, x
// [nodes, in_ch] and senders [M], all contiguous, in G = ceil(in_ch /
// per) groups of `per` input channels: per is a multiple of the P
// channels a K tile holds, or at least in_ch (refused with
// cudaErrorInvalidValue otherwise). With G > 1, part [G, M, out_ch] is
// scratch. Returns a cudaError_t.
int gpde_last_contract(const float* h, int64_t M, int K, const float* wl,
                       const float* bl, const float* x,
                       const int64_t* senders, float* msg, float* part,
                       int in_ch, int out_ch, int per, int round_bf16,
                       void* stream) {
  int ow = 1;
  while (ow < out_ch && ow < BN) ow <<= 1;
  if (per < 1 || (per % (BN / ow) != 0 && per < in_ch)) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (in_ch + per - 1) / per;
  if (groups > 65535 || (groups > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = K % 8 == 0 && out_ch % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(h) |
                    reinterpret_cast<uintptr_t>(wl)) % 16 == 0;
  auto go = [&](auto rb, auto v) {
    return launch_last_contract<decltype(rb)::value, decltype(v)::value>(
        h, M, K, wl, bl, x, senders, msg, part, in_ch, out_ch, ow, per, s);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (round_bf16) return vec ? go(T{}, T{}) : go(T{}, F{});
  return vec ? go(F{}, T{}) : go(F{}, F{});
}

}  // extern "C"
