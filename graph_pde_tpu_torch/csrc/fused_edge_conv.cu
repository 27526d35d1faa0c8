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
// card's ops:byte balance. This first version runs on the fp32 SIMT
// units (67 TFLOP/s), not the tensor cores.
//
// What the design does about it: one block of 256 threads owns a tile
// of 128 edges. Its h2 tile stays in shared memory (k-major, 128 KB) for
// the whole block, so every K column tile is a [128 x 256] x [256 x 128]
// product whose A operand never leaves the SM. Wl is streamed from L2 in
// [16 x 128] slabs, double-buffered through shared memory with the next
// slab fetched into registers while the current one is consumed. Each
// thread keeps an 8x8 register tile of K (64 FMAs per 4 shared-memory
// vector loads) and folds it straight into its 8x4 message accumulators:
// a 128-column tile is exactly the columns of two input channels i, i+1.
//
// That single-launch form takes two small layers with kw2 % 128 == 0,
// out_channels == 64 and an h2 tile that fits shared memory (the
// neurips1/UAI GKN shapes). Every other shape the JAX gate admits (wider
// or more small layers, other widths) takes the general form at the end
// of this file, which keeps the small activations in a device scratch
// buffer and streams them; K stays on chip there too.
//
// ROUND_BF16 mirrors compute_dtype='bfloat16' of the JAX kernel: GEMM
// operands (attr, W0, h1, W1, h2, Wl, x) are rounded to bf16, products
// accumulate in fp32, biases stay fp32, and each K*x product is rounded
// to bf16 before the sum over i, as the JAX o-major body does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TE = 128;       // edges per block
constexpr int BN = 128;       // K columns per tile (two input channels)
constexpr int BK = 16;        // depth of one staged B slab
constexpr int THREADS = 256;
constexpr int OUT = 64;       // out_channels this kernel takes
constexpr int MAX_ADIM = 16;  // edge attribute width bound

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

// The same product with both operands streamed from global memory and
// every bound checked: c[r][j] += sum_k A[m0 + row(r)][k] * B[k][col(j)]
// over k < K, with A row-major [M][K] and B row-major with leading dim
// ldb. Tile column bc + q of this thread's B loads (bc = (tid & 15) * 8)
// is B column boff[q], or zero where boff[q] < 0; rows >= M and k >= K
// read as zero. As: shared 2 x [BK][TE] (k-major), Bs: shared
// 2 x [BK][BN]. Ends with a barrier.
template <bool RB>
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
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = k0 + ak + q;
      sa[q] = (a_live && k < K) ? __ldg(a_row + k) : 0.f;
      sb[q] = (kb < K && boff[q] >= 0) ? __ldg(B + kb * ldb + boff[q]) : 0.f;
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

template <bool RB>
__global__ void __launch_bounds__(THREADS, 1)
edge_messages_kernel(const float* __restrict__ x,
                     const int64_t* __restrict__ senders,
                     const float* __restrict__ attr,
                     const float* __restrict__ w0, const float* __restrict__ b0,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ wl, const float* __restrict__ bl,
                     float* __restrict__ msg, int64_t E, int in_ch,
                     int a_dim, int kw1, int kw2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h2t = smem;                                   // [kw2][TE]
  float* reg = h2t + (size_t)kw2 * TE;                 // h1t [kw1][TE], then xt [in][TE]
  float* bs = reg + (size_t)(kw1 > in_ch ? kw1 : in_ch) * TE;  // 2 x [BK][BN]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t e0 = (int64_t)blockIdx.x * TE;
  const int C = in_ch * OUT;

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

  // 3. xt[i][e] = x[senders[e], i]  (the gather, folded in)
  for (int idx = tid; idx < TE * in_ch; idx += THREADS) {
    const int e = idx / in_ch;
    const int i = idx - e * in_ch;
    float v = 0.f;
    if (e0 + e < E) v = rnd<RB>(__ldg(x + senders[e0 + e] * in_ch + i));
    reg[i * TE + e] = v;
  }
  __syncthreads();

  // 4. msg[e, o] = sum_i x[e, i] * (h2 @ Wl + bl)[e, i*64 + o]
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  for (int i0 = 0; i0 < in_ch; i0 += 2) {
    const int n0 = i0 * OUT;
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
      const float xa = reg[i0 * TE + row];
      const float xb = reg[(i0 + 1) * TE + row];
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

  // 5. store the valid rows
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t e = e0 + tile_row(ty, r);
    if (e < E) {
      *reinterpret_cast<float4*>(msg + e * OUT + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

template <bool RB>
int launch(const float* x, const int64_t* senders, const float* attr,
           const float* w0, const float* b0, const float* w1, const float* b1,
           const float* wl, const float* bl, float* msg, int64_t E, int in_ch,
           int a_dim, int kw1, int kw2, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kw2 * TE +
                       (size_t)(kw1 > in_ch ? kw1 : in_ch) * TE +
                       2 * BK * BN);
  cudaError_t err = cudaFuncSetAttribute(
      edge_messages_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (E + TE - 1) / TE;
  edge_messages_kernel<RB><<<(unsigned)blocks, THREADS, smem, stream>>>(
      x, senders, attr, w0, b0, w1, b1, wl, bl, msg, E, in_ch, a_dim, kw1,
      kw2);
  return (int)cudaGetLastError();
}

// ---- General form: every shape the JAX gate admits ----
//
// Any number of small layers (zero included), any widths, any in/out.
// Per chunk of edges (the Python wrapper loops over chunks):
//   dense_relu_kernel, once per small layer: h <- relu(h @ W + b), with
//     h in a device scratch buffer. These are the small activations,
//     never K.
//   last_contract_kernel: per tile of 128 edges, streams h and Wl and
//     folds each 128-column tile of K into the messages in registers.
// A K tile holds P = 128 / ow input channels of ow output columns each,
// ow = out_ch rounded up to a power of two, at most 128 (above 128
// outputs, blockIdx.y picks the block's 128 outputs and P = 1). Threads
// whose columns share an output meet in shared memory at the end and
// are summed in a fixed order.

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
  tile_gemm_streamed<RB>(A, M, K, m0, W, N, boff, as, bs, c);
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

template <bool RB>
__global__ void __launch_bounds__(THREADS, 1)
last_contract_kernel(const float* __restrict__ h, int64_t M, int K,
                     const float* __restrict__ wl,
                     const float* __restrict__ bl,
                     const float* __restrict__ x,
                     const int64_t* __restrict__ senders,
                     float* __restrict__ msg, int in_ch, int out_ch,
                     int ow) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* as = smem;                  // 2 x [BK][TE]
  float* bs = smem + 2 * BK * TE;    // 2 x [BK][BN]
  float* red = smem;                 // [TE][BN] once the tiles are done

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.x * TE;
  const int o0 = blockIdx.y * BN;
  const int P = BN / ow;
  const int64_t C = (int64_t)in_ch * out_ch;

  int64_t src[8];                    // x row offset of each of my edges
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t row = m0 + tile_row(ty, r);
    src[r] = row < M ? senders[row] * in_ch : -1;
  }
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }

  for (int i0 = 0; i0 < in_ch; i0 += P) {
    // tile column col is channel i0 + col / ow, output o0 + col % ow
    int boff[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = tx * 8 + q;
      const int i = i0 + col / ow, o = o0 + col % ow;
      boff[q] = (i < in_ch && o < out_ch) ? i * out_ch + o : -1;
    }
    float c[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[r][j] = 0.f;
    }
    tile_gemm_streamed<RB>(h, M, K, m0, wl, C, boff, as, bs, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tile_col(tx, j);
      const int i = i0 + col / ow, o = o0 + col % ow;
      if (i >= in_ch || o >= out_ch) continue;
      const float bias = __ldg(bl + i * out_ch + o);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (src[r] < 0) continue;
        const float xv = rnd<RB>(__ldg(x + src[r] + i));
        const float kv = c[r][j] + bias;
        if constexpr (RB) {
          acc[r][j] += rnd<RB>(kv * xv);
        } else {
          acc[r][j] = fmaf(kv, xv, acc[r][j]);
        }
      }
    }
  }

  // tile_gemm_streamed ended with a barrier: as and bs are free
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[tile_row(ty, r) * BN + tile_col(tx, j)] = acc[r][j];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TE * ow; idx += THREADS) {
    const int e = idx / ow, o = idx - e * ow;
    const int64_t row = m0 + e;
    if (row >= M || o0 + o >= out_ch) continue;
    float s = 0.f;
    for (int g = 0; g < P; ++g) s += red[e * BN + g * ow + o];
    msg[row * out_ch + o0 + o] = s;
  }
}

constexpr size_t kLastSmem = sizeof(float) * TE * BN;  // red; as + bs fit

template <bool RB>
int launch_dense_relu(const float* A, int64_t M, int K, const float* W,
                      const float* b, int N, float* out,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)((M + TE - 1) / TE),
                  (unsigned)((N + BN - 1) / BN));
  dense_relu_kernel<RB><<<grid, THREADS, 0, stream>>>(A, M, K, W, b, N, out);
  return (int)cudaGetLastError();
}

template <bool RB>
int launch_last_contract(const float* h, int64_t M, int K, const float* wl,
                         const float* bl, const float* x,
                         const int64_t* senders, float* msg, int in_ch,
                         int out_ch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      last_contract_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLastSmem);
  if (err != cudaSuccess) return (int)err;
  int ow = 1;
  while (ow < out_ch && ow < BN) ow <<= 1;
  const dim3 grid((unsigned)((M + TE - 1) / TE),
                  (unsigned)((out_ch + BN - 1) / BN));
  last_contract_kernel<RB><<<grid, THREADS, kLastSmem, stream>>>(
      h, M, K, wl, bl, x, senders, msg, in_ch, out_ch, ow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape contract (checked by the Python wrapper): out_channels == 64,
// in_ch even, a_dim <= 16, kw1 % 16 == 0, kw2 % 128 == 0, shared memory
// 4 * (128 * (kw2 + max(kw1, in_ch)) + 4096) bytes <= 227 KB, every
// pointer 16-byte aligned and contiguous. Returns a cudaError_t.
int gpde_edge_messages(const float* x, const int64_t* senders,
                       const float* attr, const float* w0, const float* b0,
                       const float* w1, const float* b1, const float* wl,
                       const float* bl, float* msg, int64_t E, int in_ch,
                       int a_dim, int kw1, int kw2, int round_bf16,
                       void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (round_bf16) {
    return launch<true>(x, senders, attr, w0, b0, w1, b1, wl, bl, msg, E,
                        in_ch, a_dim, kw1, kw2, s);
  }
  return launch<false>(x, senders, attr, w0, b0, w1, b1, wl, bl, msg, E,
                       in_ch, a_dim, kw1, kw2, s);
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
// [nodes, in_ch] and senders [M], all contiguous. Returns a cudaError_t.
int gpde_last_contract(const float* h, int64_t M, int K, const float* wl,
                       const float* bl, const float* x,
                       const int64_t* senders, float* msg, int in_ch,
                       int out_ch, int round_bf16, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (round_bf16) {
    return launch_last_contract<true>(h, M, K, wl, bl, x, senders, msg,
                                      in_ch, out_ch, s);
  }
  return launch_last_contract<false>(h, M, K, wl, bl, x, senders, msg,
                                     in_ch, out_ch, s);
}

}  // extern "C"
