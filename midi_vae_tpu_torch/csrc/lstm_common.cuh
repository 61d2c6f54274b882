// Shared device code of the per-block LSTM kernels (M: lstm_decode.cu, and
// L's per-block route: lstm_layer_fwd.cu): one LSTM cell step over a tile
// of batch rows held in shared memory, and the decode heads' readout.
//
// Layout (as the GRU kernels, gru_common.cuh): one block owns R = kRows
// batch rows for the whole time loop; blockDim.x == H and thread j owns
// hidden column j of all four gates (i, f, g, o: the gate order of
// midi_vae_tpu/ops/fused_lstm.py::_lstm_gates). h and c of the block's rows
// live in shared memory feature-major, a[k * R + row]. h is double-buffered:
// a cell reads h_{t-1} from one buffer and writes h_t into another, so a step
// needs one barrier, at its end, instead of two. c is read and written by
// its own column's thread only. W (D, 4H), U (H, 4H) and b (4H,) stay in
// global memory and are re-read from L2 at every step: one f32 U is 1 MiB at
// H = 256, more than a block's 227 KB of shared memory. Each weight a thread
// loads feeds R FMAs.
#pragma once

#include "gru_common.cuh"

namespace mvt {

// Column j's four gates of x_t @ W + b for the block's R rows: the bias, then
// x_s (D, R) against W (D, 4H), read from L2 (W and b of type TW, summed in
// float).
template <int R = kRows, typename TW = float>
__device__ __forceinline__ void lstm_x_gates(
    const float* x_s, int D, const TW* __restrict__ W,
    const TW* __restrict__ bias, int H, float ai[R], float af[R],
    float ag[R], float ao[R]) {
  const int j = threadIdx.x;
  const int G = 4 * H;
  float v[R];
  {
    const float bi = to_f32(bias[j]), bf = to_f32(bias[H + j]),
                bg = to_f32(bias[2 * H + j]), bo = to_f32(bias[3 * H + j]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = bi;
      af[r] = bf;
      ag[r] = bg;
      ao[r] = bo;
    }
  }
  for (int d = 0; d < D; ++d) {
    const TW* wd = W + (size_t)d * G;
    const float wi = to_f32(wd[j]), wf = to_f32(wd[H + j]),
                wg = to_f32(wd[2 * H + j]), wo = to_f32(wd[3 * H + j]);
    load_rows<R>(x_s + d * R, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = fmaf(v[r], wi, ai[r]);
      af[r] = fmaf(v[r], wf, af[r]);
      ag[r] = fmaf(v[r], wg, ag[r]);
      ao[r] = fmaf(v[r], wo, ao[r]);
    }
  }
}

// The recurrent part of one LSTM step for the block's R rows; ai, af, ag and
// ao arrive holding column j's x_t @ W + b and are consumed:
//   [i, f, g, o] += h @ U
//   c' = sigmoid(f) * c + sigmoid(i) * act(g);  h' = sigmoid(o) * act(c')
// h_s, hn_s and c_s are (H, R), feature-major; the new h goes to hn_s, the
// new c over c_s (thread j writes column j only), each rounded as a TS holds
// it, h' from the unrounded c' (_lstm_gates, then astype). U (H, 4H) is of
// type TU. Every thread of the block must call it, after a barrier that
// completed h_s; it ends with a barrier, after which hn_s holds h' (the
// caller swaps h_s and hn_s).
template <int ACT, int R = kRows, typename TU = float, typename TS = float>
__device__ __forceinline__ void lstm_cell_recurrent(
    float ai[R], float af[R], float ag[R], float ao[R], const float* h_s,
    float* hn_s, float* c_s, const TU* __restrict__ U, int H) {
  const int j = threadIdx.x;
  const int G = 4 * H;
  float v[R];
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const TU* uk = U + (size_t)k * G;
    const float ui = to_f32(uk[j]), uf = to_f32(uk[H + j]),
                ug = to_f32(uk[2 * H + j]), uo = to_f32(uk[3 * H + j]);
    load_rows<R>(h_s + k * R, v);
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
    const float c = activate<kSigmoid>(af[r]) * c_s[j * R + r] +
                    activate<kSigmoid>(ai[r]) * activate<ACT>(ag[r]);
    c_s[j * R + r] = round_as<TS>(c);
    hn_s[j * R + r] = round_as<TS>(activate<kSigmoid>(ao[r]) * activate<ACT>(c));
  }
  __syncthreads();
}

// One LSTM step for the block's R rows:
//   [i, f, g, o] = x @ W + h @ U + b, then as lstm_cell_recurrent.
// x_s is (D, R), h_s, hn_s and c_s are (H, R), all feature-major; W, U and
// b of type TW, which is also the type h' and c' are rounded as. Every
// thread of the block must call it, after a barrier that completed x_s and
// h_s; it ends with a barrier, after which hn_s holds h'.
template <int ACT, int R = kRows, typename TW = float>
__device__ __forceinline__ void lstm_cell(
    const float* x_s, int D, const float* h_s, float* hn_s, float* c_s,
    const TW* __restrict__ W, const TW* __restrict__ U,
    const TW* __restrict__ bias, int H) {
  float ai[R], af[R], ag[R], ao[R];
  lstm_x_gates<R, TW>(x_s, D, W, bias, H, ai, af, ag, ao);
  lstm_cell_recurrent<ACT, R, TW, TW>(ai, af, ag, ao, h_s, hn_s, c_s, U, H);
}

// The readout of a decode head for the block's R rows: logits = h @ Wo + bo
// into l_s, probs = OUT(logits) into x_s (softmax over D, one warp per row),
// both (D, R) feature-major. Every thread must call it, after a barrier that
// completed h_s; it ends with a barrier. (The same arithmetic as the readout
// in gru_decode_body.cuh.)
template <int OUT, int R = kRows>
__device__ __forceinline__ void decode_readout(
    const float* h_s, const float* __restrict__ wo,
    const float* __restrict__ bo, float* x_s, float* l_s, int D, int H) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float acc = bo[d];
    for (int k = 0; k < H; ++k) acc = fmaf(h_s[k * R + r], wo[(size_t)k * D + d], acc);
    l_s[d * R + r] = acc;
  }
  __syncthreads();
  if constexpr (OUT == kSoftmax) {
    for (int r = warp; r < R; r += n_warps) {
      float m = __int_as_float(0xff800000);  // -inf
      for (int d = lane; d < D; d += 32) m = fmaxf(m, l_s[d * R + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float e = expf(l_s[d * R + r] - m);
        x_s[d * R + r] = e;
        s += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      for (int d = lane; d < D; d += 32) x_s[d * R + r] /= s;
    }
  } else {
    for (int i = tid; i < R * D; i += blockDim.x) x_s[i] = activate<OUT>(l_s[i]);
  }
  __syncthreads();
}

}  // namespace mvt
