// The autoregressive decode of one head over the block's R batch rows:
// the body of kernel B (gru_decode.cu, serving) and kernel D
// (gru_decode_train.cu, training, which also writes each layer's h sequence
// as the backward's residual).
//
// Per step t: the layer cells run on the previous step's activated output
// (start at t = 0), logits = h_last @ Wo + bo, probs = act(logits), and
// probs is fed back as the next input. probs, logits and (when the pointers
// are not null) h1seq, h2seq leave the kernel time-major, (T, B, .) each.
//
// Layout: one block owns R batch rows and runs the whole time loop (R = 8 in
// kernel B and kernel D's narrow build, 2 in D's wide build);
// the GRU states, the fed-back probs and the logits of its rows live in
// shared memory, and the weights (W1, U1, W2, U2, Wo) are re-read from L2 at
// every step. The output dense layer and the softmax over D (one warp per
// row) are inside the loop, so nothing but the outputs touches device memory.
//
// TV is the operands' type: float, or bf16 in kernel D's bf16 build
// (_dec_fwd1/2_kernel in a bf16 model). There every product sums in float,
// layer 2 takes layer 1's float h of the same step and the readout the top
// layer's float h; only what the Pallas kernel stores is rounded to bf16:
// the carried states (after the readout has read them), the h sequences,
// probs and logits, and the probs fed back as the next input.
//
// TS is the type the h sequences are stored as: TV, or bf16 in kernel D's
// bf16-residual build (a float model with decode_residual_bf16,
// _mh_fwd_kernel storing h1seq, h2seq and hkseq in residual_dtype): the
// carries, probs and logits stay float and bit-equal to the float build's,
// and only the stored sequences are rounded.
#pragma once

#include "gru_common.cuh"

namespace mvt {

// floats of shared memory decode_head<NL, ..., R> needs
inline size_t decode_smem_floats(int n_layers, int D, int H, int rows = kRows) {
  return (size_t)rows * (2 * D + (n_layers + 1) * H);
}

template <int NL, int ACT, int OUT, int R = kRows, typename TV = float,
          typename TS = TV>
__device__ __forceinline__ void decode_head(
    const TV* __restrict__ start, const TV* __restrict__ h1_0,
    const nondeduced<TV>* __restrict__ h2_0,
    const TV* __restrict__ w1, const TV* __restrict__ u1,
    const TV* __restrict__ b1,
    const nondeduced<TV>* __restrict__ w2, const nondeduced<TV>* __restrict__ u2,
    const nondeduced<TV>* __restrict__ b2,
    const TV* __restrict__ wo, const TV* __restrict__ bo,
    TV* __restrict__ probs, TV* __restrict__ logits,
    nondeduced<TS>* __restrict__ h1seq, nondeduced<TS>* __restrict__ h2seq,
    int T, int B, int D, int H, float* smem) {
  float* x_s = smem;             // (D, R) fed-back probs
  float* l_s = x_s + R * D;      // (D, R) logits
  float* h1_s = l_s + R * D;     // (H, R)
  float* h2_s = h1_s + R * H;    // (H, R), 2-layer heads only
  float* rh_s = h2_s + (NL == 2 ? R * H : 0);
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  load_tile<R>(start, x_s, row0, B, D);
  load_tile<R>(h1_0, h1_s, row0, B, H);
  if constexpr (NL == 2) load_tile<R>(h2_0, h2_s, row0, B, H);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // the new states stay float until the readout has read them
    gru_cell<ACT, R, TV, float>(x_s, D, h1_s, rh_s, w1, u1, b1, H);
    const float* hl = h1_s;
    if constexpr (NL == 2) {
      gru_cell<ACT, R, TV, float>(h1_s, H, h2_s, rh_s, w2, u2, b2, H);
      hl = h2_s;
    }
    // logits = h_last @ Wo + bo; thread i owns (row r, column d)
    for (int i = tid; i < R * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      float acc = to_f32(bo[d]);
      for (int k = 0; k < H; ++k) {
        acc = fmaf(hl[k * R + r], to_f32(wo[(size_t)k * D + d]), acc);
      }
      l_s[d * R + r] = acc;
    }
    __syncthreads();
    if constexpr (!std::is_same_v<TV, float>) {
      // the carries as the Pallas scratch holds them; thread j owns column
      // j, and nothing reads the states until the barrier after the softmax
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h1_s[tid * R + r] = round_as<TV>(h1_s[tid * R + r]);
        if constexpr (NL == 2) h2_s[tid * R + r] = round_as<TV>(h2_s[tid * R + r]);
      }
    }
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
        // the fed-back probs as the Pallas scratch holds them
        for (int d = lane; d < D; d += 32) x_s[d * R + r] = round_as<TV>(x_s[d * R + r] / s);
      }
    } else {
      for (int i = tid; i < R * D; i += blockDim.x) x_s[i] = round_as<TV>(activate<OUT>(l_s[i]));
    }
    __syncthreads();
    // the next step's first writes to l_s, x_s, h1_s and h2_s come after the
    // barriers inside gru_cell, so these reads cannot race them
    store_tile<R>(x_s, probs + (size_t)t * B * D, row0, B, D);
    store_tile<R>(l_s, logits + (size_t)t * B * D, row0, B, D);
    if (h1seq != nullptr) store_tile<R>(h1_s, h1seq + (size_t)t * B * H, row0, B, H);
    if constexpr (NL == 2) {
      if (h2seq != nullptr) store_tile<R>(h2_s, h2seq + (size_t)t * B * H, row0, B, H);
    }
  }
}

}  // namespace mvt
