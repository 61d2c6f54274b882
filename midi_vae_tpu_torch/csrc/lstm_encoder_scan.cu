// Kernel Y: one whole LSTM encoder layer in bf16 over a precomputed
// x-projection xp = x @ W + b, emitting the h sequence or only the final h.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_lstm.py::_encoder_kernel
// (:228), reached through _encoder_scan_pallas (:302, grid over T) and
// _encoder_scan_wide_pallas (:343, the batch-tiled grid taken where
// _encoder_vmem_ok fails: LSTM(512) at B = 256) from fused_lstm_encoder_scan
// (:387). The JAX package runs it only for bf16 training with
// fused_train_encoder=False (models/vae.py:255-260, models/rnn.py:165-172);
// its backward is no kernel: _fles_bwd (:430) recomputes the plain scan under
// jax.vjp, and the port's autograd Function does the same
// (ops/encoder_scan.py).
//
// Numerics, as the Pallas kernel's (_lstm_gates): xp, h0, c0, U and the
// output are bf16; h @ U (preferred_element_type=float32) and the gate math
// run in float, h' comes from the unrounded c', and both h and c are rounded
// to bf16 after every step (:242-243). Templated on the cell activation (on g
// and on c: tanh, sigmoid or relu) and on whether the h sequence is emitted.
//
// Design: kernel Q (lstm_layer_xp_fwd.cu) over bf16 operands. One block owns
// kRows = 8 batch rows and loops over all T steps; h (double-buffered) and c
// of its rows live in shared memory as float holding bf16 values; thread j
// reads its four gates of xp[t] straight from global memory and adds h @ U
// from the L2-resident U (2 MiB in bf16 at H = 512). Both TPU grids map to
// the same grid here: blocks tile the batch and carry their rows' state
// through the whole sequence. Compiled under __launch_bounds__(kWideThreads),
// so a block of up to 512 threads (H <= 512) always has the registers it
// needs.
//
// What bounds it: the serial chain of T steps, each an L2 read of U by each
// of the B/8 blocks (32 SMs work at B = 256), not the tensor-core rate that
// bounds the same work in bf16.
#include "lstm_common.cuh"

namespace mvt {

template <int ACT, bool SEQ>
__global__ void __launch_bounds__(kWideThreads) lstm_encoder_scan_kernel(
    const bf16* __restrict__ xp, const bf16* __restrict__ h0,
    const bf16* __restrict__ c0, const bf16* __restrict__ u,
    bf16* __restrict__ out, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // (H, kRows), h_{t-1}
  float* hn_s = h_s + kRows * H;   // (H, kRows), h_t
  float* c_s = hn_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  load_tile(c0, c_s, row0, B, H);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    float ai[kRows], af[kRows], ag[kRows], ao[kRows];
    load_gates4(xp + (size_t)t * B * 4 * H, row0, B, H, ai, af, ag, ao);
    // the previous step's cell ended with a barrier; its h_t (now h_s) is
    // only read from here on, and this cell writes the other buffer
    lstm_cell_recurrent<ACT, kRows, bf16, bf16>(ai, af, ag, ao, h_s, hn_s, c_s,
                                                u, H);
    float* done = hn_s;
    hn_s = h_s;
    h_s = done;
    if constexpr (SEQ) store_tile(h_s, out + (size_t)t * B * H, row0, B, H);
  }
  if constexpr (!SEQ) store_tile(h_s, out, row0, B, H);
}

template <int ACT, bool SEQ>
cudaError_t launch(const bf16* xp, const bf16* h0, const bf16* c0,
                   const bf16* u, bf16* out, int T, int B, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * 3 * H;
  cudaError_t err = fit_block(lstm_encoder_scan_kernel<ACT, SEQ>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_encoder_scan_kernel<ACT, SEQ><<<grid, H, smem, stream>>>(
      xp, h0, c0, u, out, T, B, H);
  return cudaGetLastError();
}

template <bool SEQ>
cudaError_t launch_act(const bf16* xp, const bf16* h0, const bf16* c0,
                       const bf16* u, bf16* out, int T, int B, int H, int act,
                       cudaStream_t stream) {
  switch (act) {
    case kTanh:
      return launch<kTanh, SEQ>(xp, h0, c0, u, out, T, B, H, stream);
    case kSigmoid:
      return launch<kSigmoid, SEQ>(xp, h0, c0, u, out, T, B, H, stream);
    case kRelu:
      return launch<kRelu, SEQ>(xp, h0, c0, u, out, T, B, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// xp (T, B, 4H), h0 and c0 (B, H), u (H, 4H), all bf16 and contiguous; out
// is (T, B, H) with return_sequences, else (B, H).
extern "C" int mvt_lstm_encoder_scan(const mvt::bf16* xp, const mvt::bf16* h0,
                                     const mvt::bf16* c0, const mvt::bf16* u,
                                     mvt::bf16* out, int T, int B, int H,
                                     int act, int return_sequences,
                                     void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(return_sequences
                   ? launch_act<true>(xp, h0, c0, u, out, T, B, H, act, s)
                   : launch_act<false>(xp, h0, c0, u, out, T, B, H, act, s));
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
