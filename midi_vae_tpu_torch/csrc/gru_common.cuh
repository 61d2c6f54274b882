// Shared device code of the GRU kernels: activations and one reset-before
// GRU cell step over a tile of batch rows held in shared memory.
//
// Layout (both kernels): one block owns kRows batch rows for the whole time
// loop; blockDim.x == H and thread j owns hidden column j of all three gates.
// Activations live in shared memory feature-major, a[k * kRows + row], so the
// kRows values a thread needs for one k are two float4 loads (a broadcast:
// every thread of the block reads the same address). The weights W, U (and
// Wo) are read from global memory at every step; at H = 256 one f32 U is
// 768 KiB, more than a block's 227 KB of shared memory, so they stay in the
// 50 MB L2 and every block streams them from there. Each U element a thread
// loads feeds kRows FMAs.
#pragma once

#include <cuda_runtime.h>

namespace mvt {

// batch rows per block
constexpr int kRows = 8;

// activation codes, shared with the Python wrappers
enum Act : int { kTanh = 0, kSigmoid = 1, kRelu = 2, kLinear = 3, kSoftmax = 4 };

template <int A>
__device__ __forceinline__ float activate(float x) {
  if constexpr (A == kTanh) {
    return tanhf(x);
  } else if constexpr (A == kSigmoid) {
    return 1.0f / (1.0f + expf(-x));
  } else if constexpr (A == kRelu) {
    return fmaxf(x, 0.0f);
  } else {
    return x;
  }
}

__device__ __forceinline__ void load_rows(const float* __restrict__ a, float v[kRows]) {
  const float4 lo = *reinterpret_cast<const float4*>(a);
  const float4 hi = *reinterpret_cast<const float4*>(a + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One GRU step for the block's kRows rows, in place on h_s:
//   xp = x @ W + b;  hz, hr = h @ U[:, :2H]
//   z = sigmoid(xp_z + hz);  r = sigmoid(xp_r + hr)
//   hh = act(xp_h + (r * h) @ U[:, 2H:]);  h = z * h + (1 - z) * hh
// x_s is (D, kRows), h_s and rh_s are (H, kRows), all feature-major.
// W is (D, 3H), U is (H, 3H), b is (3H,), row-major in global memory.
// Every thread of the block must call it; it ends with a barrier, after
// which h_s holds the new state.
template <int ACT>
__device__ __forceinline__ void gru_cell(
    const float* x_s, int D, float* h_s, float* rh_s,
    const float* __restrict__ W, const float* __restrict__ U,
    const float* __restrict__ bias, int H) {
  const int j = threadIdx.x;
  const int G = 3 * H;
  float az[kRows], ar[kRows], ah[kRows], v[kRows];
  const float bz = bias[j], br = bias[H + j], bh = bias[2 * H + j];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    az[r] = bz;
    ar[r] = br;
    ah[r] = bh;
  }
  for (int d = 0; d < D; ++d) {
    const float* wd = W + (size_t)d * G;
    const float wz = wd[j], wr = wd[H + j], wh = wd[2 * H + j];
    load_rows(x_s + d * kRows, v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      az[r] = fmaf(v[r], wz, az[r]);
      ar[r] = fmaf(v[r], wr, ar[r]);
      ah[r] = fmaf(v[r], wh, ah[r]);
    }
  }
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float* uk = U + (size_t)k * G;
    const float uz = uk[j], ur = uk[H + j];
    load_rows(h_s + k * kRows, v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      az[r] = fmaf(v[r], uz, az[r]);
      ar[r] = fmaf(v[r], ur, ar[r]);
    }
  }
  float hold[kRows];
  load_rows(h_s + j * kRows, hold);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    az[r] = activate<kSigmoid>(az[r]);  // z
    rh_s[j * kRows + r] = activate<kSigmoid>(ar[r]) * hold[r];
  }
  // the reset gate multiplies h BEFORE the U_h product: every column of
  // r * h must be in shared memory before any thread starts that product
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float uh = U[(size_t)k * G + 2 * H + j];
    load_rows(rh_s + k * kRows, v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) ah[r] = fmaf(v[r], uh, ah[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float hh = activate<ACT>(ah[r]);
    h_s[j * kRows + r] = az[r] * hold[r] + (1.0f - az[r]) * hh;
  }
  __syncthreads();
}

// Loads rows [row0, row0 + kRows) of a row-major (B, D) matrix into the
// feature-major (D, kRows) tile a_s; rows past B read as zeros.
__device__ __forceinline__ void load_tile(
    const float* __restrict__ a, float* a_s, int row0, int B, int D) {
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, row = row0 + r;
    a_s[d * kRows + r] = row < B ? a[(size_t)row * D + d] : 0.0f;
  }
}

// Stores the feature-major tile a_s into rows [row0, row0 + kRows) of a
// row-major (B, D) matrix, skipping rows past B.
__device__ __forceinline__ void store_tile(
    const float* a_s, float* __restrict__ a, int row0, int B, int D) {
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, row = row0 + r;
    if (row < B) a[(size_t)row * D + d] = a_s[d * kRows + r];
  }
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mvt
