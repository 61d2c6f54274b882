// The x-projection pre-pass of the whole-layer forward kernels L
// (lstm_layer_fwd.cu) and A (gru_layer_fwd.cu): xp (M, N) = x (M, K) @ W
// (K, N) + b over all M = T B rows of a layer at once, stored float32, on
// the tensor cores (gemm_tc.cuh's mainloop, tiles of 128 x 128).
//
// The TPU kernels compute xp = x_t @ W + b inside every step
// (fused_train.py::_lstm_fwdx_kernel :2368, ::_fwdx_kernel :2071), before
// the recurrent product; x_t @ W does not depend on h, so it leaves the
// serial chain. Float32 operands take the three-product TF32 split (float32
// accuracy); bf16 operands one TF32 product each (a bf16 value is exact in
// TF32: the bf16 products summed in float, as _dot's
// preferred_element_type); the velocity layer's cast_x (D < 8, bf16: x and
// W widened to float32 in the JAX wrapper) gives the same products, with K
// padded with zeros. The bias is added in float (b_ref[:].astype(f32)).
// What bounds it: writing xp (48 MiB for a GRU(256) layer at T 64, B 256).
#pragma once

#include "gemm_tc.cuh"

namespace mvt {

constexpr int kXprojBM = 128;

template <typename TV>
__global__ void __launch_bounds__(tc::kThreads) xproj_kernel(
    const TV* __restrict__ x, const TV* __restrict__ w, const TV* __restrict__ b,
    float* __restrict__ xp, int M, int K, int N, int a_vec, int b_vec) {
  using G = tc::Gemm<false, TV, TV, kXprojBM,
                     std::is_same_v<TV, bf16> ? tc::kOne : tc::kThree>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kXprojBM, n0 = blockIdx.x * tc::kBN;
  typename G::Acc acc;
  G::run(x, K, w, N, m0, M, n0, N, 0, K, a_vec, b_vec, smem, acc, nullptr);
#pragma unroll
  for (int nt = 0; nt < G::kNT; ++nt) {
    const int n = n0 + G::col_of(nt, 0);  // even, and N is a multiple of 4
    if (n >= N) continue;
    const float b0 = to_f32(b[n]), b1 = to_f32(b[n + 1]);
#pragma unroll
    for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + G::row_of(mt, 2 * half);
        if (m < M) {
          *reinterpret_cast<float2*>(xp + (size_t)m * N + n) =
              make_float2(acc[mt][nt][2 * half] + b0, acc[mt][nt][2 * half + 1] + b1);
        }
      }
    }
  }
}

// x (M, K), w (K, N), b (N,) contiguous, xp (M, N) float32; returns a
// cudaError_t code
template <typename TV>
int xproj(const TV* x, const TV* w, const TV* b, float* xp, int M, int K, int N,
          void* stream) {
  using G = tc::Gemm<false, TV, TV, kXprojBM,
                     std::is_same_v<TV, bf16> ? tc::kOne : tc::kThree>;
  if (M < 1 || K < 1 || N < 4 || N % 4 != 0 ||
      (reinterpret_cast<size_t>(xp) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = xproj_kernel<TV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies of float rows that are 16-byte multiples (bf16: staged)
  const bool f32 = std::is_same_v<TV, float>;
  const int a_vec = f32 && K % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const int b_vec = f32 && (reinterpret_cast<size_t>(w) & 15) == 0;
  const dim3 grid(N / tc::kBN + (N % tc::kBN != 0), (M + kXprojBM - 1) / kXprojBM);
  kernel<<<grid, tc::kThreads, G::kSmem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, xp, M, K, N, a_vec, b_vec);
  return (int)cudaGetLastError();
}

}  // namespace mvt
