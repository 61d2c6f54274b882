// Kernel B: a whole autoregressive GRU decode head in one kernel.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_decoder.py::
// _decode_kernel_2layer and ::_decode_kernel_1layer, reached through
// fused_decode_scan. Templated on the number of GRU layers (1 or 2), the
// cell activation and the output activation (softmax, sigmoid or linear).
//
// Per step t: the layer cells run on the previous step's activated output
// (start at t = 0), logits = h_last @ Wo + bo, probs = act(logits), and
// probs is fed back as the next input. probs and logits leave the kernel
// time-major, (T, B, D) each.
//
// Design: as kernel A (gru_layer_fwd.cu), one block owns kRows = 8 batch
// rows and runs the whole time loop; the GRU states, the fed-back probs and
// the logits of its rows live in shared memory, and the weights (W1, U1, W2,
// U2, Wo) are re-read from L2 at every step. The output dense layer and the
// softmax over D (one warp per row) are inside the kernel, so nothing but
// the outputs touches device memory during the loop.
//
// What bounds it: the serial chain of T steps (2 barriers per layer and 2
// for the readout), and per step an L2 read of every weight by every block.
#include "gru_common.cuh"

namespace mvt {

template <int NL, int ACT, int OUT>
__global__ void gru_decode_kernel(
    const float* __restrict__ start, const float* __restrict__ h1_0,
    const float* __restrict__ h2_0,
    const float* __restrict__ w1, const float* __restrict__ u1,
    const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ u2,
    const float* __restrict__ b2,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ probs, float* __restrict__ logits,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
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
    // the next step's first writes to l_s and x_s come after the barriers
    // inside gru_cell, so these reads cannot race them
    store_tile(x_s, probs + (size_t)t * B * D, row0, B, D);
    store_tile(l_s, logits + (size_t)t * B * D, row0, B, D);
  }
}

template <int NL, int ACT, int OUT>
cudaError_t launch(const float* start, const float* h1_0, const float* h2_0,
                   const float* w1, const float* u1, const float* b1,
                   const float* w2, const float* u2, const float* b2,
                   const float* wo, const float* bo, float* probs,
                   float* logits, int T, int B, int D, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (2 * D + (NL + 1) * H);
  cudaError_t err = allow_smem(gru_decode_kernel<NL, ACT, OUT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_decode_kernel<NL, ACT, OUT><<<grid, H, smem, stream>>>(
      start, h1_0, h2_0, w1, u1, b1, w2, u2, b2, wo, bo, probs, logits,
      T, B, D, H);
  return cudaGetLastError();
}

template <int NL, int ACT>
cudaError_t by_out(int out_act, const float* start, const float* h1_0,
                   const float* h2_0, const float* w1, const float* u1,
                   const float* b1, const float* w2, const float* u2,
                   const float* b2, const float* wo, const float* bo,
                   float* probs, float* logits, int T, int B, int D, int H,
                   cudaStream_t s) {
  switch (out_act) {
    case kSoftmax:
      return launch<NL, ACT, kSoftmax>(start, h1_0, h2_0, w1, u1, b1, w2, u2,
                                       b2, wo, bo, probs, logits, T, B, D, H, s);
    case kSigmoid:
      return launch<NL, ACT, kSigmoid>(start, h1_0, h2_0, w1, u1, b1, w2, u2,
                                       b2, wo, bo, probs, logits, T, B, D, H, s);
    case kLinear:
      return launch<NL, ACT, kLinear>(start, h1_0, h2_0, w1, u1, b1, w2, u2,
                                      b2, wo, bo, probs, logits, T, B, D, H, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int NL>
cudaError_t by_act(int act, int out_act, const float* start, const float* h1_0,
                   const float* h2_0, const float* w1, const float* u1,
                   const float* b1, const float* w2, const float* u2,
                   const float* b2, const float* wo, const float* bo,
                   float* probs, float* logits, int T, int B, int D, int H,
                   cudaStream_t s) {
  switch (act) {
    case kTanh:
      return by_out<NL, kTanh>(out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                               b2, wo, bo, probs, logits, T, B, D, H, s);
    case kSigmoid:
      return by_out<NL, kSigmoid>(out_act, start, h1_0, h2_0, w1, u1, b1, w2,
                                  u2, b2, wo, bo, probs, logits, T, B, D, H, s);
    case kRelu:
      return by_out<NL, kRelu>(out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                               b2, wo, bo, probs, logits, T, B, D, H, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// h2_0, w2, u2 and b2 are ignored (and may be null) when n_layers == 1.
extern "C" int mvt_gru_decode(
    const float* start, const float* h1_0, const float* h2_0,
    const float* w1, const float* u1, const float* b1,
    const float* w2, const float* u2, const float* b2,
    const float* wo, const float* bo, float* probs, float* logits,
    int T, int B, int D, int H, int n_layers, int act, int out_act,
    void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || D < 1 || H < 32 || H > 1024 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers == 1) {
    return (int)by_act<1>(act, out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                          b2, wo, bo, probs, logits, T, B, D, H, s);
  }
  if (n_layers == 2) {
    return (int)by_act<2>(act, out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                          b2, wo, bo, probs, logits, T, B, D, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
