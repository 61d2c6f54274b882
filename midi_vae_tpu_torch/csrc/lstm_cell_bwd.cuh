// Shared device code of the LSTM backward kernels (N: lstm_layer_bwd.cu, R:
// lstm_layer_xp_bwd.cu): one reverse step of the LSTM cell with tanh cell
// activations, over the block's R batch rows.
//
// Math (midi_vae_tpu/ops/fused_train.py::_lstm_bwdx_kernel :2429-2464 and
// _lstm_bwd_wide_kernel :1944-1976), h = h_{t-1}, c_p = c_{t-1}:
//   recompute  [i, f, g, o] = sig, sig, tanh, sig of xp_t + h.U;  tc = tanh(c_t)
//   dc  = dc_carry + dh*o*(1 - tc^2)
//   da  = [dc*g*i(1-i), dc*c_p*f(1-f), dc*i*(1-g^2), dh*tc*o(1-o)]
//   dh_{t-1} = da.U^T;   dc_{t-1} = dc*f
// Only tanh's derivative is written here, as in the TPU kernels
// (_lstm_x_use_pallas and _lstm_mode send other cell activations to the
// plain scan). The weight gradients are not summed here: the step emits the
// gate grads da (gate order i, f, g, o) and kernel W (grad_reduce.cu)
// reduces dW = x^T.da, db and dU = h_{t-1}^T.da over all T*B rows afterwards.
//
// Layout as in gru_common.cuh: blockDim.x == H, thread j owns hidden column j
// of the four gates, and its dh and dc carries stay in registers. The gate
// grads of the block's rows go to a (4H, R) shared tile, because
// dh_{t-1} = da.U^T needs every gate column: 32 KiB at H = 256. The
// transposed product reads UT = U^T (4H, H), so that neighbouring threads
// read neighbouring addresses.
//
// In the bf16 builds (N and R in a bf16 model) c_{t-1}, c_t, U and U^T are
// bf16, each widened to float as it is loaded: the whole transposition and
// the dh and dc carries stay float, as the Pallas kernels widen what they
// load and carry dh and dc in float scratch.
#pragma once

#include "lstm_common.cuh"

namespace mvt {

// The reverse step from the gates' x-projection on: ai, af, ag and ao arrive
// holding column j's xp_t = x_t @ W + b and are consumed. hp_s (H, R) is
// h_{t-1}; cprev and ccur are c_{t-1} and c_t, row-major (B, H) in global
// memory (thread j reads its own column). dh holds dL/dh_t (d_seq[t] already
// added) and is replaced by dL/dh_{t-1}; dc holds the carried dL/dc and is
// replaced by dL/dc_{t-1}. Writes da_s (4H, R). Every thread of the block
// must call it, after a barrier that completed hp_s and after every read of
// da_s from the previous step; da_s is complete from its inner barrier on.
// cprev, ccur, U and UT are of type TV.
template <int R = kRows, typename TV = float>
__device__ __forceinline__ void lstm_cell_bwd_recurrent(
    float ai[R], float af[R], float ag[R], float ao[R], const float* hp_s,
    const TV* __restrict__ cprev, const TV* __restrict__ ccur, int row0,
    int B, float dh[R], float dc[R], float* da_s,
    const TV* __restrict__ U, const TV* __restrict__ UT, int H) {
  const int j = threadIdx.x;
  const int G = 4 * H;
  float v[R];
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const TV* uk = U + (size_t)k * G;
    const float ui = to_f32(uk[j]), uf = to_f32(uk[H + j]),
                ug = to_f32(uk[2 * H + j]), uo = to_f32(uk[3 * H + j]);
    load_rows<R>(hp_s + k * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = fmaf(v[r], ui, ai[r]);
      af[r] = fmaf(v[r], uf, af[r]);
      ag[r] = fmaf(v[r], ug, ag[r]);
      ao[r] = fmaf(v[r], uo, ao[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const float cp = row < B ? to_f32(cprev[(size_t)row * H + j]) : 0.0f;
    const float ct = row < B ? to_f32(ccur[(size_t)row * H + j]) : 0.0f;
    const float i = activate<kSigmoid>(ai[r]), f = activate<kSigmoid>(af[r]);
    const float g = tanhf(ag[r]), o = activate<kSigmoid>(ao[r]);
    const float tc = tanhf(ct);
    const float d = dc[r] + dh[r] * o * (1.0f - tc * tc);
    da_s[j * R + r] = d * g * i * (1.0f - i);
    da_s[(H + j) * R + r] = d * cp * f * (1.0f - f);
    da_s[(2 * H + j) * R + r] = d * i * (1.0f - g * g);
    da_s[(3 * H + j) * R + r] = dh[r] * tc * o * (1.0f - o);
    dc[r] = d * f;
    dh[r] = 0.0f;
  }
  __syncthreads();
  // dh_{t-1}[j] = sum_g da[g] U[j, g] = sum_g da[g] UT[g, j]
#pragma unroll 4
  for (int g = 0; g < G; ++g) {
    const float u = to_f32(UT[(size_t)g * H + j]);
    load_rows<R>(da_s + g * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = fmaf(v[r], u, dh[r]);
  }
}

}  // namespace mvt
