// Shared device code of the per-block backward kernels (G:
// gru_layer_xp_bwd.cu, V: gru_encoder_stack_bwd.cu): one reverse step of the
// reset-before GRU cell with a tanh candidate, over the block's R batch rows.
// (C and E run as phases on clusters since their redesign:
// gru_cell_bwd_chain.cuh.)
//
// Math (midi_vae_tpu/ops/fused_train.py::_gru_cell_bwd_core), h = h_{t-1}:
//   recompute  z = sig(xz + h.Uz)  r = sig(xr + h.Ur)  hh = tanh(xh + (r*h).Uh)
//   dz = dh*(h - hh)           da   = dh*(1-z)*(1-hh^2)
//   drh = da.Uh^T              da_z = dz*z*(1-z)     da_r = drh*h*r*(1-r)
//   dx  = [da_z, da_r, da].W^T
//   dh_{t-1} = dh*z + drh*r + [da_z, da_r].U[:, :2H]^T
// The weight gradients are not summed here: the step emits the gate grads
// da_cat = [da_z, da_r, da] and r*h, and kernel W (grad_reduce.cu) reduces
// them over all T*B rows afterwards.
//
// Layout as in gru_common.cuh: blockDim.x == H, thread j owns hidden column
// j; tiles are feature-major in shared memory, a[k * R + row]. The
// transposed products read UT = U^T (3H, H) and WT = W^T (3H, D), so that
// neighbouring threads read neighbouring addresses there too. The weights
// are of type TW: float, or bf16 in the bf16 builds, widened as they are
// loaded (every product and gate grad stays float, as the Pallas
// backward widens its operands to float32).
#pragma once

#include "gru_common.cuh"

namespace mvt {

// The step from the recomputed gates on: az, ar and ah arrive holding
// x_t @ W + b of column j (the z, r and candidate gates; kernel G reads them
// from the forward's x-projection) and are consumed. hp_s (H, R) is h_{t-1};
// dh holds dL/dh_t for column j of the block's rows and is replaced by
// dL/dh_{t-1}. Writes da_s (3H, R) = da_cat, rh_s (H, R) = r * h_{t-1} and,
// when dx_s is not null, dx_s (D, R) = da_cat @ W^T. Every thread of the
// block must call it; it ends with a barrier, after which the outputs are
// visible.
template <int R = kRows, typename TW = float>
__device__ __forceinline__ void gru_cell_bwd_recurrent(
    float az[R], float ar[R], float ah[R], const float* hp_s, float dh[R],
    float* da_s, float* rh_s, float* dx_s, const TW* __restrict__ U,
    const nondeduced<TW>* __restrict__ UT,
    const nondeduced<TW>* __restrict__ WT, int D, int H) {
  const int j = threadIdx.x;
  const int G = 3 * H;
  float v[R];
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const TW* uk = U + (size_t)k * G;
    const float uz = to_f32(uk[j]), ur = to_f32(uk[H + j]);
    load_rows<R>(hp_s + k * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      az[r] = fmaf(v[r], uz, az[r]);
      ar[r] = fmaf(v[r], ur, ar[r]);
    }
  }
  float hp[R], z[R], rg[R];
  load_rows<R>(hp_s + j * R, hp);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    z[r] = activate<kSigmoid>(az[r]);
    rg[r] = activate<kSigmoid>(ar[r]);
    rh_s[j * R + r] = rg[r] * hp[r];
  }
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float uh = to_f32(U[(size_t)k * G + 2 * H + j]);
    load_rows<R>(rh_s + k * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) ah[r] = fmaf(v[r], uh, ah[r]);
  }
  // az now carries dz, ah the candidate's pre-activation grad da
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float hh = tanhf(ah[r]);
    az[r] = dh[r] * (hp[r] - hh);
    ah[r] = dh[r] * (1.0f - z[r]) * (1.0f - hh * hh);
    da_s[(2 * H + j) * R + r] = ah[r];
  }
  __syncthreads();
  // drh = da @ U[:, 2H:]^T, read from rows 2H.. of U^T
  float drh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) drh[r] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < H; ++i) {
    const float u = to_f32(UT[(size_t)(2 * H + i) * H + j]);
    load_rows<R>(da_s + (2 * H + i) * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) drh[r] = fmaf(v[r], u, drh[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float da_z = az[r] * z[r] * (1.0f - z[r]);
    const float da_r = drh[r] * hp[r] * rg[r] * (1.0f - rg[r]);
    da_s[j * R + r] = da_z;
    da_s[(H + j) * R + r] = da_r;
    dh[r] = dh[r] * z[r] + drh[r] * rg[r];
  }
  __syncthreads();
  // dh_{t-1} += [da_z, da_r] @ U[:, :2H]^T
#pragma unroll 4
  for (int g = 0; g < 2 * H; ++g) {
    const float u = to_f32(UT[(size_t)g * H + j]);
    load_rows<R>(da_s + g * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = fmaf(v[r], u, dh[r]);
  }
  if (dx_s != nullptr) {
    for (int d = j; d < D; d += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int g = 0; g < G; ++g) {
        const float w = to_f32(WT[(size_t)g * D + d]);
        load_rows<R>(da_s + g * R, v);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) dx_s[d * R + r] = acc[r];
    }
  }
  __syncthreads();
}

// One reverse step from the step input: x_s (D, R) is x_t and the gates are
// recomputed from it (x_t @ W + b), then gru_cell_bwd_recurrent.
template <int R = kRows, typename TW = float>
__device__ __forceinline__ void gru_cell_bwd(
    const float* x_s, int D, const float* hp_s, float dh[R], float* da_s,
    float* rh_s, float* dx_s, const TW* __restrict__ W,
    const TW* __restrict__ U, const TW* __restrict__ bias,
    const nondeduced<TW>* __restrict__ UT,
    const nondeduced<TW>* __restrict__ WT, int H) {
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
  // the forward's gates, recomputed from x_t and h_{t-1}
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
  gru_cell_bwd_recurrent<R, TW>(az, ar, ah, hp_s, dh, da_s, rh_s, dx_s, U, UT,
                                WT, D, H);
}

}  // namespace mvt
