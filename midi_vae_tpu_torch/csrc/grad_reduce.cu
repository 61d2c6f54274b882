// Kernel W: the weight-gradient reduction of the backward kernels,
//   C (I, J) = A^T B = sum over n of A[n, :]^T B[n, :]   and, optionally,
//   bias (J,) = sum over n of B[n, :],
// with A (N, I) and B (N, J) row-major, N = T * B rows of a backward pass.
//
// Replaces the in-kernel accumulation of the TPU kernels
// midi_vae_tpu/ops/fused_train.py::_bwdx_kernel (dw/db/du refs, :2175-2178),
// ::_dec_bwd1/2_kernel and ::_mh_bwd_kernel (dw/du/db/dwo/dbo refs), the
// float32 sums of _outer_acc (:57-60): one f32 U of GRU(256) is 768 KiB,
// above a block's 227 KB of shared memory, and blocks run in no order and
// share nothing, so the sums leave the serial kernels (C, E) as gate grads
// and this second pass reduces them, as the JAX package's wide scheme does
// (_gru_wide_weight_grads, _dec_wide_weight_grads). It serves dW (x^T
// da_cat), dU[:, :2H] (h_{t-1}^T da_zr), dU[:, 2H:] ((r*h)^T da), dWo (h^T
// dlogits) and the bias sums. Operands may be column slices of wider
// matrices: each has its own leading dimension.
//
// Design: the product on the tensor cores at float32 accuracy
// (gemm_tc.cuh: each float32 operand split into a TF32 high part and
// remainder, three TF32 products summed in float; a bf16 A is exact in TF32,
// so two), 128 x 128 tiles of C (64 x 128 where I <= 64) over a ring of four
// 16-row stages filled by cp.async. To fill the card when C has few tiles
// (GRU(256)'s dU has 12), the rows n are split into S contiguous chunks
// (grid z); each chunk writes its partial tile to a workspace and a second
// kernel sums the S partials in a fixed order. The bias is plain float sums
// of B's staged tiles, taken by the blocks of the first row of tiles, so it
// costs no tile of its own. No atomics: two runs give the same bits.
//
// At I <= 16 (the velocity layer's x, I = 1; the instrument layer's, 16) a
// 128-row tile would be almost all padding, and the work is bound by reading
// B once: the small instance streams B, each thread four columns of it and
// eight rows at a time, and sums I + 1 products a row in float FMAs (A's
// rows, the same for every thread, staged in shared memory).
//
// A bf16 build (mvt_grad_reduce_bf16) serves a bf16 model: A is the stored
// bf16 activations (x, h_{t-1}, a decode head's fed-back probs and top h),
// widened to float as it is staged; B, the gate grads or dlogits, is float
// and never rounded, and the sums are float, as the Pallas backward kernels
// accumulate _outer_acc(x.astype(f32), da_cat) in float32.
//
// Built with -DMVT_W_TF32_ONE the float build takes one TF32 product of the
// rounded operands instead of three: not the function of W (about 3e-4
// relative off a float64 sum), only chip_smoke.py's control that its limit
// tells the two apart.
#include "gemm_tc.cuh"

namespace mvt {

#ifdef MVT_W_TF32_ONE
constexpr int kF32Products = tc::kOne;
#else
constexpr int kF32Products = tc::kThree;
#endif
// the widest A the small instance takes, and its columns a thread
constexpr int kSmallI = 16;
constexpr int kSmallCols = 4;
constexpr int kSmallThreads = 256;
// rows of A the small instance stages in shared memory at a time
constexpr int kSmallRows = 256;

template <typename TA>
constexpr int kProducts = std::is_same_v<TA, bf16> ? tc::kTwo : kF32Products;

// rows [n0, n1) of the reduction into tile (blockIdx.y, blockIdx.x); its C
// (and with the bias, row I) to part's chunk blockIdx.z, or with part null
// to c and bias
template <typename TA, int kBM>
__global__ void __launch_bounds__(tc::kThreads) grad_reduce_tc_kernel(
    const TA* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
    float* __restrict__ c, int ldc, float* __restrict__ bias, float* __restrict__ part, int N,
    int I, int J, int with_bias, int chunk, int a_vec, int b_vec) {
  using G = tc::Gemm<true, TA, float, kBM, kProducts<TA>>;
  extern __shared__ __align__(16) float smem[];
  const int Ie = I + with_bias;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * tc::kBN;
  const int n0 = blockIdx.z * chunk, n1 = min(N, n0 + chunk);
  const bool sums = with_bias && blockIdx.y == 0;
  float bsum = 0.0f;
  typename G::Acc acc;
  G::run(a, lda, b, ldb, i0, I, j0, J, n0, n1, a_vec, b_vec, smem, acc,
         sums ? &bsum : nullptr);
  auto put = [&](int i, int j, float v) {
    if (part != nullptr) {
      part[((size_t)blockIdx.z * Ie + i) * J + j] = v;
    } else if (i < I) {
      c[(size_t)i * ldc + j] = v;
    } else {
      bias[j] = v;
    }
  };
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + G::row_of(mt, e), j = j0 + G::col_of(nt, e);
        if (i < I && j < J) put(i, j, acc[mt][nt][e]);
      }
  if (sums) {  // the two row halves of each column, in order
    __syncthreads();
    smem[threadIdx.x] = bsum;
    __syncthreads();
    const int j = j0 + threadIdx.x;
    if (threadIdx.x < tc::kBN && j < J) {
      put(I, j, smem[threadIdx.x] + smem[threadIdx.x + tc::kBN]);
    }
  }
}

// I <= kSmallI: thread t of block x covers columns x * 1024 + t + 256 q
// (q < 4; with vec, the four of x * 1024 + 4 t) over rows [n0, n1), taken
// kSmallRows at a time: the block stages their A rows (I values each) in
// shared memory, then each thread loads 8 rows of its columns of B at once
template <typename TA, bool kVec>
__global__ void __launch_bounds__(kSmallThreads, 1) grad_reduce_small_kernel(
    const TA* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
    float* __restrict__ c, int ldc, float* __restrict__ bias, float* __restrict__ part, int N,
    int I, int J, int with_bias, int chunk) {
  __shared__ float a_s[kSmallRows * kSmallI];
  const int Ie = I + with_bias;
  const int base = blockIdx.x * kSmallThreads * kSmallCols;
  int cols[kSmallCols];
#pragma unroll
  for (int q = 0; q < kSmallCols; ++q) {
    cols[q] = kVec ? base + kSmallCols * threadIdx.x + q : base + threadIdx.x + kSmallThreads * q;
  }
  const int n0 = blockIdx.z * chunk, n1 = min(N, n0 + chunk);
  float acc[kSmallI + 1][kSmallCols];
#pragma unroll
  for (int k = 0; k <= kSmallI; ++k)
#pragma unroll
    for (int q = 0; q < kSmallCols; ++q) acc[k][q] = 0.0f;
  for (int r0 = n0; r0 < n1; r0 += kSmallRows) {
    const int rows = min(kSmallRows, n1 - r0);
    __syncthreads();  // every thread is done with the last rows' A
    for (int e = threadIdx.x; e < rows * I; e += kSmallThreads) {
      a_s[e] = to_f32(a[(size_t)(r0 + e / I) * lda + e % I]);
    }
    __syncthreads();
    if (cols[0] >= J) continue;  // (the thread's first column is its lowest)
    for (int r = 0; r < rows; r += 8) {
      float bv[8][kSmallCols];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const bool ok = r + rr < rows;
        const float* br = b + (size_t)(r0 + r + rr) * ldb;
        if constexpr (kVec) {
          const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(br + cols[0]))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          bv[rr][0] = v.x, bv[rr][1] = v.y, bv[rr][2] = v.z, bv[rr][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < kSmallCols; ++q) {
            bv[rr][q] = ok && cols[q] < J ? __ldg(br + cols[q]) : 0.0f;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        if (r + rr >= rows) break;
        const float* ar = a_s + (r + rr) * I;
#pragma unroll
        for (int k = 0; k < kSmallI; ++k) {
          if (k < I) {
#pragma unroll
            for (int q = 0; q < kSmallCols; ++q) acc[k][q] = fmaf(ar[k], bv[rr][q], acc[k][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kSmallCols; ++q) acc[kSmallI][q] += bv[rr][q];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSmallCols; ++q) {
    const int j = cols[q];
    if (j >= J) continue;
#pragma unroll
    for (int k = 0; k <= kSmallI; ++k) {
      const int i = k < kSmallI ? k : I;  // the bias sums go to row I
      if ((k < kSmallI && k >= I) || (k == kSmallI && !with_bias)) continue;
      if (part != nullptr) {
        part[((size_t)blockIdx.z * Ie + i) * J + j] = acc[k][q];
      } else if (i < I) {
        c[(size_t)i * ldc + j] = acc[k][q];
      } else {
        bias[j] = acc[k][q];
      }
    }
  }
}

// sums the S partial (Ie, J) products in order s = 0 .. S-1
__global__ void grad_reduce_sum_kernel(const float* __restrict__ part, int S,
                                       float* __restrict__ c, int ldc,
                                       float* __restrict__ bias, int I, int J,
                                       int with_bias) {
  const int Ie = I + with_bias;
  const size_t total = (size_t)Ie * J;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += part[(size_t)k * total + e];
    const int i = (int)(e / J), jj = (int)(e - (size_t)i * J);
    if (i < I) {
      c[(size_t)i * ldc + jj] = s;
    } else {
      bias[jj] = s;
    }
  }
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <typename TA, int kBM>
cudaError_t launch_tc(const TA* a, int lda, const float* b, int ldb, float* c, int ldc,
                      float* bias, float* part, int N, int I, int J, int with_bias, int chunk,
                      int S, cudaStream_t s) {
  using G = tc::Gemm<true, TA, float, kBM, kProducts<TA>>;
  auto kernel = grad_reduce_tc_kernel<TA, kBM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmem);
  if (err != cudaSuccess) return err;
  // 16-byte copies: float A and B whose rows, width and base are 16-byte
  // multiples (bf16 A is staged through registers)
  const int a_vec = std::is_same_v<TA, float> && lda % 4 == 0 && I % 4 == 0 && aligned16(a);
  const int b_vec = ldb % 4 == 0 && J % 4 == 0 && aligned16(b);
  const dim3 grid((J + tc::kBN - 1) / tc::kBN, (I + kBM - 1) / kBM, S);
  kernel<<<grid, tc::kThreads, G::kSmem, s>>>(a, lda, b, ldb, c, ldc, bias, part, N, I, J,
                                               with_bias, chunk, a_vec, b_vec);
  return cudaGetLastError();
}

template <typename TA>
int reduce(const TA* a, int lda, const float* b, int ldb, float* c, int ldc, float* bias,
           float* part, int N, int I, int J, int splits, void* stream) {
  if (N < 1 || I < 1 || J < 1 || splits < 1 || lda < I || ldb < J || ldc < J ||
      (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int with_bias = bias != nullptr ? 1 : 0;
  const int Ie = I + with_bias;
  // whole stages per chunk
  int chunk = (N + splits - 1) / splits;
  chunk = (chunk + tc::kBK - 1) / tc::kBK * tc::kBK;
  const int S = (N + chunk - 1) / chunk;
  float* p = S > 1 ? part : nullptr;
  cudaError_t err;
  if (I <= kSmallI) {
    const dim3 grid((J + kSmallThreads * kSmallCols - 1) / (kSmallThreads * kSmallCols), 1, S);
    if (ldb % 4 == 0 && J % 4 == 0 && aligned16(b)) {
      grad_reduce_small_kernel<TA, true><<<grid, kSmallThreads, 0, s>>>(
          a, lda, b, ldb, c, ldc, bias, p, N, I, J, with_bias, chunk);
    } else {
      grad_reduce_small_kernel<TA, false><<<grid, kSmallThreads, 0, s>>>(
          a, lda, b, ldb, c, ldc, bias, p, N, I, J, with_bias, chunk);
    }
    err = cudaGetLastError();
  } else if (I <= 64) {
    err = launch_tc<TA, 64>(a, lda, b, ldb, c, ldc, bias, p, N, I, J, with_bias, chunk, S, s);
  } else {
    err = launch_tc<TA, 128>(a, lda, b, ldb, c, ldc, bias, p, N, I, J, with_bias, chunk, S, s);
  }
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t total = (size_t)Ie * J;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  grad_reduce_sum_kernel<<<blocks, 256, 0, s>>>(part, S, c, ldc, bias, I, J, with_bias);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// bias may be null (no bias sums). With splits > 1, part must hold
// splits * (I + (bias != null)) * J floats; with splits == 1 it is unused.
// ops/grad_reduce.py::splits picks splits for the instance I selects.
extern "C" int mvt_grad_reduce(const float* a, int lda, const float* b, int ldb,
                               float* c, int ldc, float* bias, float* part,
                               int N, int I, int J, int splits, void* stream) {
  return mvt::reduce(a, lda, b, ldb, c, ldc, bias, part, N, I, J, splits,
                     stream);
}

// the same with A in bf16
extern "C" int mvt_grad_reduce_bf16(const mvt::bf16* a, int lda, const float* b,
                                    int ldb, float* c, int ldc, float* bias,
                                    float* part, int N, int I, int J,
                                    int splits, void* stream) {
  return mvt::reduce(a, lda, b, ldb, c, ldc, bias, part, N, I, J, splits,
                     stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
