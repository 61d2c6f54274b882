// The autoregressive decode of one head over the block's kRows batch rows:
// the body of kernel B (gru_decode.cu, serving) and kernel D
// (gru_decode_train.cu, training, which also writes each layer's h sequence
// as the backward's residual).
//
// Per step t: the layer cells run on the previous step's activated output
// (start at t = 0), logits = h_last @ Wo + bo, probs = act(logits), and
// probs is fed back as the next input. probs, logits and (when the pointers
// are not null) h1seq, h2seq leave the kernel time-major, (T, B, .) each.
//
// Layout: one block owns kRows = 8 batch rows and runs the whole time loop;
// the GRU states, the fed-back probs and the logits of its rows live in
// shared memory, and the weights (W1, U1, W2, U2, Wo) are re-read from L2 at
// every step. The output dense layer and the softmax over D (one warp per
// row) are inside the loop, so nothing but the outputs touches device memory.
#pragma once

#include "gru_common.cuh"

namespace mvt {

// floats of shared memory decode_head<NL, ...> needs
inline size_t decode_smem_floats(int n_layers, int D, int H) {
  return (size_t)kRows * (2 * D + (n_layers + 1) * H);
}

template <int NL, int ACT, int OUT>
__device__ __forceinline__ void decode_head(
    const float* __restrict__ start, const float* __restrict__ h1_0,
    const float* __restrict__ h2_0,
    const float* __restrict__ w1, const float* __restrict__ u1,
    const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ u2,
    const float* __restrict__ b2,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ probs, float* __restrict__ logits,
    float* __restrict__ h1seq, float* __restrict__ h2seq,
    int T, int B, int D, int H, float* smem) {
  float* x_s = smem;                 // (D, kRows) fed-back probs
  float* l_s = x_s + kRows * D;      // (D, kRows) logits
  float* h1_s = l_s + kRows * D;     // (H, kRows)
  float* h2_s = h1_s + kRows * H;    // (H, kRows), 2-layer heads only
  float* rh_s = h2_s + (NL == 2 ? kRows * H : 0);
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  load_tile(start, x_s, row0, B, D);
  load_tile(h1_0, h1_s, row0, B, H);
  if constexpr (NL == 2) load_tile(h2_0, h2_s, row0, B, H);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    gru_cell<ACT>(x_s, D, h1_s, rh_s, w1, u1, b1, H);
    const float* hl = h1_s;
    if constexpr (NL == 2) {
      gru_cell<ACT>(h1_s, H, h2_s, rh_s, w2, u2, b2, H);
      hl = h2_s;
    }
    // logits = h_last @ Wo + bo; thread i owns (row r, column d)
    for (int i = tid; i < kRows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      float acc = bo[d];
      for (int k = 0; k < H; ++k) acc = fmaf(hl[k * kRows + r], wo[(size_t)k * D + d], acc);
      l_s[d * kRows + r] = acc;
    }
    __syncthreads();
    if constexpr (OUT == kSoftmax) {
      for (int r = warp; r < kRows; r += n_warps) {
        float m = __int_as_float(0xff800000);  // -inf
        for (int d = lane; d < D; d += 32) m = fmaxf(m, l_s[d * kRows + r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float s = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float e = expf(l_s[d * kRows + r] - m);
          x_s[d * kRows + r] = e;
          s += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        for (int d = lane; d < D; d += 32) x_s[d * kRows + r] /= s;
      }
    } else {
      for (int i = tid; i < kRows * D; i += blockDim.x) x_s[i] = activate<OUT>(l_s[i]);
    }
    __syncthreads();
    // the next step's first writes to l_s, x_s, h1_s and h2_s come after the
    // barriers inside gru_cell, so these reads cannot race them
    store_tile(x_s, probs + (size_t)t * B * D, row0, B, D);
    store_tile(l_s, logits + (size_t)t * B * D, row0, B, D);
    if (h1seq != nullptr) store_tile(h1_s, h1seq + (size_t)t * B * H, row0, B, H);
    if constexpr (NL == 2) {
      if (h2seq != nullptr) store_tile(h2_s, h2seq + (size_t)t * B * H, row0, B, H);
    }
  }
}

}  // namespace mvt
