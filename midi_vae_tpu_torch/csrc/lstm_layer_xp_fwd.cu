// Kernel Q: one whole LSTM layer forward (tanh) over a precomputed
// x-projection xp = x @ W + b, emitting the h and c sequences.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_lstm_fwd_kernel
// (:1331), reached through lstm_layer_train as _lstm_fwd_pallas (:1352, grid
// over T) and as _lstm_fwd_wide_pallas (:1890, the batch-tiled grid), which
// the JAX package takes where the in-kernel-projection kernels are switched
// off (_lstm_layer_fallback_x, :2559-2565). The port takes it on the wide
// route (ops/_layout.py, LSTM above H = 256): xp is one torch.matmul over all
// T * B rows, and this kernel runs only the serial part. The c sequence is
// the backward's residual (kernel R, lstm_layer_xp_bwd.cu).
//
// The kernel is the forward chain on thread-block clusters of
// lstm_cell_fwd.cuh, which has the design and what bounds it: the float
// build takes h . U as FFMA (its slice of U streamed from L2 at H = 512), the
// bf16 build (rows 15 and 17 in a bf16 model, LSTM(512)'s layers at B = 256
// through _lstm_fwd_wide_pallas) on the tensor cores. In bf16, xp (which XLA
// has already rounded to bf16), h0, c0 and U are bf16, h . U is bf16
// products summed in float and the gates are float (_lstm_gates'
// preferred_element_type); h' comes from the unrounded c', and h and c are
// rounded to bf16 where the Pallas kernel carries them in its bf16 scratch
// (:1915-1916) and stores both sequences.
#include "lstm_cell_fwd.cuh"

// xp (T, B, 4H), h0 and c0 (B, H), u (H, 4H), contiguous; hseq and cseq
// (T, B, H). cluster, rows, splits and stages are the plan of
// ops/_layout.py::fwd_plan (stages 0: the slice resident).
extern "C" int mvt_lstm_layer_xp_fwd(const float* xp, const float* h0, const float* c0,
                                     const float* u, float* hseq, float* cseq, int T, int B,
                                     int H, int cluster, int rows, int splits, int stages,
                                     void* stream) {
  mvt::FwdArgs<float> a{xp, h0, c0, u, hseq, cseq, nullptr, T, B, H, rows, splits, stages};
  if (cseq == nullptr) return (int)cudaErrorInvalidValue;
  return mvt::launch_fwd_chain<float, mvt::kTanh>(a, cluster, stream);
}

// the bf16 build: every operand and output bf16
extern "C" int mvt_lstm_layer_xp_fwd_bf16(const mvt::bf16* xp, const mvt::bf16* h0,
                                          const mvt::bf16* c0, const mvt::bf16* u,
                                          mvt::bf16* hseq, mvt::bf16* cseq, int T, int B, int H,
                                          int cluster, int rows, int splits, int stages,
                                          void* stream) {
  mvt::FwdArgs<mvt::bf16> a{xp, h0, c0, u, hseq, cseq, nullptr, T, B, H, rows, splits, stages};
  if (cseq == nullptr) return (int)cudaErrorInvalidValue;
  return mvt::launch_fwd_chain<mvt::bf16, mvt::kTanh>(a, cluster, stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float, the
// resident or the streamed slice) at `cluster` CTAs a cluster
extern "C" int mvt_lstm_layer_xp_fwd_max_clusters(int bf16, int cluster, int stream_slice,
                                                  int* out) {
  return bf16 ? mvt::fwd_max_clusters<mvt::bf16, mvt::kTanh>(cluster, stream_slice, out)
              : mvt::fwd_max_clusters<float, mvt::kTanh>(cluster, stream_slice, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
