// Shared device code of the GRU kernels: activations and one reset-before
// GRU cell step over a tile of batch rows held in shared memory.
//
// Layout (every kernel): one block owns R batch rows for the whole time
// loop; blockDim.x == H and thread j owns hidden column j of all three gates.
// Activations live in shared memory feature-major, a[k * R + row], so the R
// values a thread needs for one k are two float4 loads, or one float2 at
// R = 2 (a broadcast: every thread of the block reads the same address). The weights W, U (and Wo) are
// read from global memory at every step; at H = 256 one f32 U is 768 KiB,
// more than a block's 227 KB of shared memory, so they stay in the 50 MB L2
// and every block streams them from there. Each U element a thread loads
// feeds R FMAs.
//
// Operands in global memory are float, or __nv_bfloat16 in the bf16 builds
// (kernels X and Y, and the bf16 entry points of T and S): a bf16 value is
// widened to float as it is loaded, every product and gate sums in float,
// and what a step carries (h, and the LSTM's c) is rounded to nearest even
// in bf16 where the JAX kernel stores it in its compute dtype (round_as);
// shared memory stays float. The float instantiations are the kernels'
// original code (to_f32 and round_as<float> are the identity).
//
// R is kRows = 8 for the per-block kernels (A's per-block route, B, D, F,
// G) at the widths where they launch. D's wide build (H = 512) holds
// kWideRows = 2: a thread keeps R values of every gate, carry and operand in
// registers, and at 8 rows D takes 160 registers a thread, so H = 512
// threads would need more than the 65,536 registers of an SM. Under
// __launch_bounds__(512) it gets at most 128; at 2 rows the grid has 128
// blocks at B = 256 instead of 32. (C and E run as phases on clusters:
// gru_cell_bwd_chain.cuh.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace mvt {

using bf16 = __nv_bfloat16;

// T where a template must not deduce it: a pointer parameter that callers
// may pass as nullptr takes the type deduced from the others
template <typename T>
struct type_is {
  using type = T;
};
template <typename T>
using nondeduced = typename type_is<T>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// x stored as a T: the identity for float, round to nearest even for bf16
// (jnp's astype)
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// x as a T holds it, back in float
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f32(from_f32<T>(x));
}

// batch rows per block
constexpr int kRows = 8;
// batch rows per block of the wide decode builds
constexpr int kWideRows = 2;
// threads per block that the launch-bounded builds (F, G, wide D and E) are
// compiled for: __launch_bounds__ caps their registers at 65,536 / 512 = 128
constexpr int kWideThreads = 512;

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

template <int R = kRows>
__device__ __forceinline__ void load_rows(const float* __restrict__ a, float v[R]) {
  static_assert(R == 8 || R == 2, "a tile holds 8 or 2 rows");
  if constexpr (R == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(a);
    const float4 hi = *reinterpret_cast<const float4*>(a + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
    const float2 p = *reinterpret_cast<const float2*>(a);
    v[0] = p.x; v[1] = p.y;
  }
}

// The recurrent part of one GRU step for the block's R rows, in place on
// h_s; az, ar and ah arrive holding x_t @ W + b of column j (the z, r and
// candidate gates) and are consumed:
//   z = sigmoid(az + h @ U_z);  r = sigmoid(ar + h @ U_r)
//   hh = act(ah + (r * h) @ U_h);  h = z * h + (1 - z) * hh
// h_s and rh_s are (H, R), feature-major; U is (H, 3H), row-major in global
// memory, of type TU. The new h is rounded as a TS holds it (r * h stays
// float, as the Pallas dot promotes it). Every thread of the block must call
// it; it ends with a barrier, after which h_s holds the new state.
template <int ACT, int R = kRows, typename TU = float, typename TS = float>
__device__ __forceinline__ void gru_cell_recurrent(
    float az[R], float ar[R], float ah[R], float* h_s, float* rh_s,
    const TU* __restrict__ U, int H) {
  const int j = threadIdx.x;
  const int G = 3 * H;
  float v[R];
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const TU* uk = U + (size_t)k * G;
    const float uz = to_f32(uk[j]), ur = to_f32(uk[H + j]);
    load_rows<R>(h_s + k * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      az[r] = fmaf(v[r], uz, az[r]);
      ar[r] = fmaf(v[r], ur, ar[r]);
    }
  }
  float hold[R];
  load_rows<R>(h_s + j * R, hold);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    az[r] = activate<kSigmoid>(az[r]);  // z
    rh_s[j * R + r] = activate<kSigmoid>(ar[r]) * hold[r];
  }
  // the reset gate multiplies h BEFORE the U_h product: every column of
  // r * h must be in shared memory before any thread starts that product
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float uh = to_f32(U[(size_t)k * G + 2 * H + j]);
    load_rows<R>(rh_s + k * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) ah[r] = fmaf(v[r], uh, ah[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float hh = activate<ACT>(ah[r]);
    h_s[j * R + r] = round_as<TS>(az[r] * hold[r] + (1.0f - az[r]) * hh);
  }
  __syncthreads();
}

// One GRU step for the block's R rows, in place on h_s:
//   xp = x @ W + b, then gru_cell_recurrent.
// x_s is (D, R), h_s and rh_s are (H, R), all feature-major.
// W is (D, 3H), U is (H, 3H), b is (3H,), row-major in global memory, all of
// type TW; the new h is rounded as a TS holds it (by default TW; float
// keeps it unrounded, as the stack kernel U feeds layer 1's h to layer 2).
// Every thread of the block must call it; it ends with a barrier, after
// which h_s holds the new state.
template <int ACT, int R = kRows, typename TW = float, typename TS = TW>
__device__ __forceinline__ void gru_cell(
    const float* x_s, int D, float* h_s, float* rh_s,
    const TW* __restrict__ W, const TW* __restrict__ U,
    const TW* __restrict__ bias, int H) {
  const int j = threadIdx.x;
  const int G = 3 * H;
  float az[R], ar[R], ah[R], v[R];
  const float bz = to_f32(bias[j]), br = to_f32(bias[H + j]),
              bh = to_f32(bias[2 * H + j]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    az[r] = bz;
    ar[r] = br;
    ah[r] = bh;
  }
  for (int d = 0; d < D; ++d) {
    const TW* wd = W + (size_t)d * G;
    const float wz = to_f32(wd[j]), wr = to_f32(wd[H + j]),
                wh = to_f32(wd[2 * H + j]);
    load_rows<R>(x_s + d * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      az[r] = fmaf(v[r], wz, az[r]);
      ar[r] = fmaf(v[r], wr, ar[r]);
      ah[r] = fmaf(v[r], wh, ah[r]);
    }
  }
  gru_cell_recurrent<ACT, R, TW, TS>(az, ar, ah, h_s, rh_s, U, H);
}

// Loads column j's three gates of rows [row0, row0 + R) of a row-major
// (B, 3H) x-projection into az, ar, ah; rows past B read as zeros.
template <int R = kRows, typename TX>
__device__ __forceinline__ void load_gates(
    const TX* __restrict__ xp, int row0, int B, int H, float az[R],
    float ar[R], float ah[R]) {
  const int j = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    az[r] = ar[r] = ah[r] = 0.0f;
    if (row < B) {
      const TX* x = xp + (size_t)row * 3 * H;
      az[r] = to_f32(x[j]);
      ar[r] = to_f32(x[H + j]);
      ah[r] = to_f32(x[2 * H + j]);
    }
  }
}

// Loads rows [row0, row0 + R) of a row-major (B, D) matrix into the
// feature-major (D, R) tile a_s; rows past B read as zeros.
template <int R = kRows, typename TA>
__device__ __forceinline__ void load_tile(
    const TA* __restrict__ a, float* a_s, int row0, int B, int D) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, row = row0 + r;
    a_s[d * R + r] = row < B ? to_f32(a[(size_t)row * D + d]) : 0.0f;
  }
}

// load_tile, or zeros where a is null (a zero initial state)
template <int R = kRows, typename TA>
__device__ __forceinline__ void load_tile_or_zero(
    const TA* __restrict__ a, float* a_s, int row0, int B, int D) {
  if (a != nullptr) {
    load_tile<R>(a, a_s, row0, B, D);
  } else {
    for (int i = threadIdx.x; i < R * D; i += blockDim.x) a_s[i] = 0.0f;
  }
}

// Stores the feature-major tile a_s into rows [row0, row0 + R) of a
// row-major (B, D) matrix, skipping rows past B.
template <int R = kRows, typename TA>
__device__ __forceinline__ void store_tile(
    const float* a_s, TA* __restrict__ a, int row0, int B, int D) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, row = row0 + r;
    if (row < B) a[(size_t)row * D + d] = from_f32<TA>(a_s[d * R + r]);
  }
}

// Stores column j's entries of the feature-major (n_blocks * H, R) tile a_s
// into rows [row0, row0 + R) of a row-major (B, ld) matrix, for the column
// blocks that thread j owns (j, j + H, ...); rows past B are skipped. Only
// thread j reads column j, so a thread may store the columns it wrote itself
// without a barrier. Used for gate grads (3 or 4 blocks), r*h and c (1 block).
// Each value is stored as a TA: float as it is, bf16 rounded once.
template <int R = kRows, typename TA = float>
__device__ __forceinline__ void store_columns(
    const float* a_s, TA* __restrict__ a, int row0, int B, int ld,
    int n_blocks, int H) {
  const int j = threadIdx.x;
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= B) break;
    for (int blk = 0; blk < n_blocks; ++blk) {
      a[(size_t)row * ld + blk * H + j] = from_f32<TA>(a_s[(blk * H + j) * R + r]);
    }
  }
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Readies a launch of `kernel` with `threads` threads a block and `smem`
// bytes of dynamic shared memory. The build's own limit decides the width:
// maxThreadsPerBlock is what its registers a thread (or its
// __launch_bounds__) allow, e.g. 384 for D and E at 8 rows, so a block the
// build cannot launch fails here as the launch itself would.
template <typename Kernel>
inline cudaError_t fit_block(Kernel kernel, int threads, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (threads > attr.maxThreadsPerBlock) return cudaErrorLaunchOutOfResources;
  return allow_smem(kernel, smem);
}

}  // namespace mvt
