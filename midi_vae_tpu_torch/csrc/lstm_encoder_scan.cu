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
// to bf16 after every step (:242-243). The cell activation (on g and on c)
// is tanh, sigmoid or relu.
//
// The kernel is the bf16 build of kernel Q's forward chain on thread-block
// clusters (lstm_cell_fwd.cuh has the design and what bounds it): U's
// column slices resident in the CTAs' shared memory, h . U on the tensor
// cores. Both TPU grids map to the same launch: clusters tile the batch and
// carry their rows' state through the whole sequence.
#include "lstm_cell_fwd.cuh"

// xp (T, B, 4H), h0 and c0 (B, H), u (H, 4H), all bf16 and contiguous; out
// is (T, B, H) with return_sequences, else (B, H). cluster and rows are the
// plan of ops/_layout.py::fwd_plan.
extern "C" int mvt_lstm_encoder_scan(const mvt::bf16* xp, const mvt::bf16* h0,
                                     const mvt::bf16* c0, const mvt::bf16* u,
                                     mvt::bf16* out, int T, int B, int H, int act,
                                     int return_sequences, int cluster, int rows,
                                     void* stream) {
  using namespace mvt;
  const FwdArgs<bf16> a{xp, h0, c0, u, return_sequences ? out : nullptr, nullptr,
                        return_sequences ? nullptr : out, T, B, H, rows, 1, 0};
  switch (act) {
    case kTanh: return launch_fwd_chain<bf16, kTanh>(a, cluster, stream);
    case kSigmoid: return launch_fwd_chain<bf16, kSigmoid>(a, cluster, stream);
    case kRelu: return launch_fwd_chain<bf16, kRelu>(a, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters of the chain (bf16, the slice resident) at
// `cluster` CTAs a cluster
extern "C" int mvt_lstm_encoder_scan_max_clusters(int bf16, int cluster, int stream_slice,
                                                  int* out) {
  if (!bf16) return (int)cudaErrorInvalidValue;
  return mvt::fwd_max_clusters<mvt::bf16, mvt::kTanh>(cluster, stream_slice, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
