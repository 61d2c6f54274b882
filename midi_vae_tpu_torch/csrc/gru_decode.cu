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
// the outputs touches device memory during the loop. The loop body,
// decode_head in gru_decode_body.cuh, is shared with kernel D
// (gru_decode_train.cu); this launch passes no h-sequence outputs.
//
// What bounds it: the serial chain of T steps (2 barriers per layer and 2
// for the readout), and per step an L2 read of every weight by every block.
#include "gru_decode_body.cuh"

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
  decode_head<NL, ACT, OUT>(start, h1_0, h2_0, w1, u1, b1, w2, u2, b2, wo, bo,
                            probs, logits, nullptr, nullptr, T, B, D, H, smem);
}

template <int NL, int ACT, int OUT>
cudaError_t launch(const float* start, const float* h1_0, const float* h2_0,
                   const float* w1, const float* u1, const float* b1,
                   const float* w2, const float* u2, const float* b2,
                   const float* wo, const float* bo, float* probs,
                   float* logits, int T, int B, int D, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * decode_smem_floats(NL, D, H);
  cudaError_t err = fit_block(gru_decode_kernel<NL, ACT, OUT>, H, smem);
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
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
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
