// Kernel L: one whole LSTM layer forward, x @ W computed inside the kernel.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::
// _lstm_fwdx_kernel (:2352, through _lstm_fwdx_pallas: the (T, B, H) h
// sequence and, for the training backward (kernel N, lstm_layer_bwd.cu), the
// (T, B, H) c sequence as its residual) and ::_lstm_fwdx_last_kernel (:2992,
// through _lstm_fwdx_last_pallas: the final h only), reached through
// lstm_layer_train_x and lstm_layer_infer_x. One kernel covers all three with
// the emit_seq flag and a c output that may be null (serving passes null).
// The LSTM twin of kernel A (gru_layer_fwd.cu).
//
// Design: the TPU walks time with its sequential grid and keeps W, U, b in
// VMEM. Here one block owns kRows = 8 batch rows and loops over all T steps
// itself; h (double-buffered) and c for its rows live in shared memory (see
// lstm_common.cuh). W, U and b stay in global memory and are re-read from L2
// at every step (U alone is 1 MiB at H = 256). Per step: the x_t tile, a
// barrier, then one pass over x_t @ W and h @ U for the four gates, and the
// cell update, ending with a barrier: two barriers a step.
//
// What bounds it: the serial chain of T steps, each one an L2 read of W and
// U by every block. At B = 256 the grid is 32 blocks of H = 256 threads, so
// most SMs idle; each weight loaded feeds kRows FMAs.
//
// A bf16 build (mvt_lstm_layer_fwd_bf16) runs _lstm_fwdx_kernel in a bf16
// model (row 19 in bf16, the encoder's layers of the soak's lstm_bf16): x,
// h0, c0, W, b and U in bf16, each widened to float as it is loaded, so
// x @ W + b and h @ U are bf16 products summed in float (_dot's
// preferred_element_type, b widened :2379; the velocity layer's cast_x,
// x and W widened to float, gives the same products); h' comes from the
// unrounded c', and h and c are rounded to bf16 where the Pallas kernel keeps
// them in its bf16 scratch (:2398-2399) and stores both sequences. The
// training forward only emits the sequences; serving stays float.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "lstm_common.cuh"

namespace mvt {

template <int ACT, typename TV>
__global__ void lstm_layer_fwd_kernel(
    const TV* __restrict__ x, const TV* __restrict__ h0,
    const TV* __restrict__ c0, const TV* __restrict__ w,
    const TV* __restrict__ b, const TV* __restrict__ u,
    TV* __restrict__ out, TV* __restrict__ cseq, int T, int B, int D,
    int H, int emit_seq) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;               // (D, kRows)
  float* h_s = x_s + kRows * D;    // (H, kRows), h_{t-1}
  float* hn_s = h_s + kRows * H;   // (H, kRows), h_t
  float* c_s = hn_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  load_tile(c0, c_s, row0, B, H);
  for (int t = 0; t < T; ++t) {
    // x_s and hn_s are free: the previous step's cell ended with a barrier,
    // and its h_t (now h_s) is only read from here on
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    __syncthreads();
    lstm_cell<ACT, kRows, TV>(x_s, D, h_s, hn_s, c_s, w, u, b, H);
    float* done = hn_s;
    hn_s = h_s;
    h_s = done;
    if (emit_seq) store_tile(h_s, out + (size_t)t * B * H, row0, B, H);
    // thread j stores the c column it wrote itself: no barrier needed
    if (cseq != nullptr) {
      store_columns(c_s, cseq + (size_t)t * B * H, row0, B, H, 1, H);
    }
  }
  if (!emit_seq) store_tile(h_s, out, row0, B, H);
}

template <int ACT, typename TV>
cudaError_t launch(const TV* x, const TV* h0, const TV* c0, const TV* w,
                   const TV* b, const TV* u, TV* out, TV* cseq, int T, int B,
                   int D, int H, int emit_seq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (D + 3 * H);
  cudaError_t err = fit_block(lstm_layer_fwd_kernel<ACT, TV>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_layer_fwd_kernel<ACT, TV><<<grid, H, smem, stream>>>(
      x, h0, c0, w, b, u, out, cseq, T, B, D, H, emit_seq);
  return cudaGetLastError();
}

template <typename TV>
int run(const TV* x, const TV* h0, const TV* c0, const TV* w, const TV* b,
        const TV* u, TV* out, TV* cseq, int T, int B, int D, int H, int act,
        int emit_seq, void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0 ||
      (cseq != nullptr && !emit_seq)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch<kTanh>(x, h0, c0, w, b, u, out, cseq, T, B, D, H,
                                emit_seq, s);
    case kSigmoid:
      return (int)launch<kSigmoid>(x, h0, c0, w, b, u, out, cseq, T, B, D, H,
                                   emit_seq, s);
    case kRelu:
      return (int)launch<kRelu>(x, h0, c0, w, b, u, out, cseq, T, B, D, H,
                                emit_seq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// cseq (T, B, H) may be null (c not emitted); it is written only with
// emit_seq.
extern "C" int mvt_lstm_layer_fwd(
    const float* x, const float* h0, const float* c0, const float* w,
    const float* b, const float* u, float* out, float* cseq, int T, int B,
    int D, int H, int act, int emit_seq, void* stream) {
  return mvt::run(x, h0, c0, w, b, u, out, cseq, T, B, D, H, act, emit_seq,
                  stream);
}

// the bf16 build: every operand and output bf16
extern "C" int mvt_lstm_layer_fwd_bf16(
    const mvt::bf16* x, const mvt::bf16* h0, const mvt::bf16* c0,
    const mvt::bf16* w, const mvt::bf16* b, const mvt::bf16* u,
    mvt::bf16* out, mvt::bf16* cseq, int T, int B, int D, int H, int act,
    int emit_seq, void* stream) {
  return mvt::run(x, h0, c0, w, b, u, out, cseq, T, B, D, H, act, emit_seq,
                  stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
