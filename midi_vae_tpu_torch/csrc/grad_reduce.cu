// Kernel W: the weight-gradient reduction of the backward kernels,
//   C (I, J) = A^T B = sum over n of A[n, :]^T B[n, :]   and, optionally,
//   bias (J,) = sum over n of B[n, :],
// with A (N, I) and B (N, J) row-major, N = T * B rows of a backward pass.
//
// Replaces the in-kernel accumulation of the TPU kernels
// midi_vae_tpu/ops/fused_train.py::_bwdx_kernel (dw/db/du refs, :2175-2178),
// ::_dec_bwd1/2_kernel and ::_mh_bwd_kernel (dw/du/db/dwo/dbo refs): one f32
// U of GRU(256) is 768 KiB, above a block's 227 KB of shared memory, and
// blocks run in no order and share nothing, so the sums leave the serial
// kernels (C, E) as gate grads and this second pass reduces them, as the JAX
// package's wide scheme does (_gru_wide_weight_grads, _dec_wide_weight_grads).
// It serves dW (x^T da_cat), dU[:, :2H] (h_{t-1}^T da_zr), dU[:, 2H:]
// ((r*h)^T da), dWo (h^T dlogits) and the bias sums. Operands may be column
// slices of wider matrices: each has its own leading dimension.
//
// Design: a plain shared-memory-tiled f32 product. A block computes one
// 64 x 64 tile of C from 16-row slices of A and B staged in shared memory;
// each of its 256 threads keeps a 4 x 4 sub-tile in registers. The bias rides
// as one more row of C, computed against a column of ones. To fill the card
// when C has few tiles (the encoder's dU has 32), the rows n are split into S
// contiguous chunks (grid z); each chunk writes its partial tile to a
// workspace and a second kernel sums the S partials in a fixed order. No
// atomics: two runs give the same bits.
//
// What bounds it: f32 FMA throughput outside the tensor cores (no TF32, to
// keep f32 gradients) and the shared-memory operand traffic, 8 loads per
// 16 FMAs a thread.
//
// A bf16 build (mvt_grad_reduce_bf16) serves a bf16 model: A is the stored
// bf16 activations (x, h_{t-1}, a decode head's fed-back probs and top h),
// widened to float as it is staged; B, the gate grads or dlogits, is float
// and never rounded, and the sums are float, as the Pallas backward kernels
// accumulate _outer_acc(x.astype(f32), da_cat) in float32.
#include "gru_common.cuh"

namespace mvt {

constexpr int kTile = 64;  // C tile edge
constexpr int kK = 16;     // rows of A and B per stage
constexpr int kThreads = 256;

// rows [n0, n1) of the reduction; i0/j0 the tile origin; Ie = I (+1 with bias)
template <typename TA>
__global__ __launch_bounds__(kThreads) void grad_reduce_kernel(
    const TA* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
    float* __restrict__ c, int ldc, float* __restrict__ bias,
    float* __restrict__ part, int N, int I, int J, int with_bias, int chunk) {
  __shared__ __align__(16) float a_s[kK][kTile];
  __shared__ __align__(16) float b_s[kK][kTile];
  const int Ie = I + with_bias;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int n0 = blockIdx.z * chunk;
  const int n1 = min(N, n0 + chunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  for (int n = n0; n < n1; n += kK) {
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int k = e / kTile, col = e - k * kTile;
      const int row = n + k;
      const int i = i0 + col, jj = j0 + col;
      float av = 0.0f, bv = 0.0f;
      if (row < n1) {
        if (i < I) {
          av = to_f32(a[(size_t)row * lda + i]);
        } else if (i < Ie) {
          av = 1.0f;  // the bias row
        }
        if (jj < J) bv = b[(size_t)row * ldb + jj];
      }
      a_s[k][col] = av;
      b_s[k][col] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(ar[p], br[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= Ie) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jj = j0 + tx * 4 + q;
      if (jj >= J) continue;
      if (part != nullptr) {
        part[((size_t)blockIdx.z * Ie + i) * J + jj] = acc[p][q];
      } else if (i < I) {
        c[(size_t)i * ldc + jj] = acc[p][q];
      } else {
        bias[jj] = acc[p][q];
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

template <typename TA>
int reduce(const TA* a, int lda, const float* b, int ldb, float* c, int ldc,
           float* bias, float* part, int N, int I, int J, int splits,
           void* stream) {
  if (N < 1 || I < 1 || J < 1 || splits < 1 || lda < I || ldb < J || ldc < J ||
      (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int with_bias = bias != nullptr ? 1 : 0;
  const int Ie = I + with_bias;
  // whole kK-row stages per chunk
  int chunk = (N + splits - 1) / splits;
  chunk = (chunk + kK - 1) / kK * kK;
  const int S = (N + chunk - 1) / chunk;
  const dim3 grid((J + kTile - 1) / kTile, (Ie + kTile - 1) / kTile, S);
  grad_reduce_kernel<TA><<<grid, kThreads, 0, s>>>(a, lda, b, ldb, c, ldc, bias,
                                                   S > 1 ? part : nullptr, N, I,
                                                   J, with_bias, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t total = (size_t)Ie * J;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  grad_reduce_sum_kernel<<<blocks, 256, 0, s>>>(part, S, c, ldc, bias, I, J,
                                                with_bias);
  return (int)cudaGetLastError();
}

}  // namespace mvt

// bias may be null (no bias sums). With splits > 1, part must hold
// splits * (I + (bias != null)) * J floats; with splits == 1 it is unused.
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
