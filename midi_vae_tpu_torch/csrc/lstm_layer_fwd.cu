// Kernel L: one whole LSTM layer forward with the x-projection, in two
// phases on the card.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::
// _lstm_fwdx_kernel (:2352, through _lstm_fwdx_pallas: the (T, B, H) h
// sequence and, for the training backward (kernel N, lstm_layer_bwd.cu), the
// (T, B, H) c sequence as its residual) and ::_lstm_fwdx_last_kernel (:2992,
// through _lstm_fwdx_last_pallas: the final h only), reached through
// lstm_layer_train_x and lstm_layer_infer_x.
//
// Design. Inside a step the TPU kernel computes xp = x_t @ W + b (:2368)
// before _lstm_gates adds h @ U; x_t @ W does not depend on h, so it leaves
// the serial chain:
//   1. the pre-pass (mvt_lstm_layer_xproj): xp (T B, 4H) = x @ W + b over
//      all T B rows at once, stored float32, on the tensor cores
//      (xproj.cuh, which kernel A's pre-pass shares): float32 operands
//      through the three-product TF32 split, bf16 operands as one TF32
//      product each; the bias added in float (b_ref[:].astype(f32), :2379);
//   2. the chain (mvt_lstm_layer_fwd_chain): kernels Q's and Y's forward
//      chain on thread-block clusters (lstm_cell_fwd.cuh has the design and
//      what bounds it) over that xp, for every cell activation (tanh,
//      sigmoid, relu), emitting the h sequence, the c sequence (training)
//      or only the final h (emit_seq = 0: row 21 and serving). The bf16
//      build reads the float xp, so x @ W + b enters the gates unrounded as
//      in _lstm_fwdx_kernel, and carries h and c rounded to bf16 where the
//      Pallas kernel keeps them in its bf16 scratch (:2398-2399).
// What bounds the pre-pass is writing xp (64 MiB at T 64, B 256, H 256);
// the chain, its T steps.
//
// The first design stays as a named route for widths the chain does not
// run (H not a multiple of 64 in float32, or of 128 in bf16;
// ops/_layout.py::lstm_fwd_route picks it, never after a failed launch):
// mvt_lstm_layer_fwd, one block of kRows = 8 batch rows and H threads for
// all T steps, h (double-buffered) and c in shared memory (lstm_common.cuh),
// W, U and b re-read from L2 at every step, x_t @ W and h @ U as FFMA; in
// bf16 every operand widened as it is loaded. It is bound by its serial
// steps, each an L2 read of W and U by each of B / 8 blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "lstm_cell_fwd.cuh"
#include "xproj.cuh"

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

// ---------------------------------------------------------------------------
// The chain over xp (float32 in both builds)
// ---------------------------------------------------------------------------

template <typename TV>
int chain(const float* xp, const TV* h0, const TV* c0, const TV* u, TV* hseq, TV* cseq,
          TV* hlast, int T, int B, int H, int act, int cluster, int rows, int splits, int stages,
          void* stream) {
  const FwdArgs<TV, float> a{xp, h0, c0, u, hseq, cseq, hlast, T, B, H, rows, splits, stages};
  if ((hseq == nullptr) == (hlast == nullptr) || (cseq != nullptr && hseq == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (act) {
    case kTanh: return launch_fwd_chain<TV, kTanh, float>(a, cluster, stream);
    case kSigmoid: return launch_fwd_chain<TV, kSigmoid, float>(a, cluster, stream);
    case kRelu: return launch_fwd_chain<TV, kRelu, float>(a, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// The pre-pass: x (M, K), w (K, N), b (N,) contiguous, xp (M, N) float32;
// M = T B, K = D, N = 4H.
extern "C" int mvt_lstm_layer_xproj(const float* x, const float* w, const float* b, float* xp,
                                    int M, int K, int N, void* stream) {
  return mvt::xproj(x, w, b, xp, M, K, N, stream);
}

// the bf16 build: x, w, b bf16, xp float32
extern "C" int mvt_lstm_layer_xproj_bf16(const mvt::bf16* x, const mvt::bf16* w,
                                         const mvt::bf16* b, float* xp, int M, int K, int N,
                                         void* stream) {
  return mvt::xproj(x, w, b, xp, M, K, N, stream);
}

// The chain: xp (T, B, 4H) float32, h0 and c0 (B, H), u (H, 4H), contiguous;
// either hseq (T, B, H), with cseq (T, B, H) or null, or hlast (B, H) alone.
// cluster, rows, splits and stages are the plan of ops/_layout.py::fwd_plan
// for build "L_chain" (float32) or "L_chain_bf16".
extern "C" int mvt_lstm_layer_fwd_chain(const float* xp, const float* h0, const float* c0,
                                        const float* u, float* hseq, float* cseq, float* hlast,
                                        int T, int B, int H, int act, int cluster, int rows,
                                        int splits, int stages, void* stream) {
  return mvt::chain(xp, h0, c0, u, hseq, cseq, hlast, T, B, H, act, cluster, rows, splits,
                    stages, stream);
}

// the bf16 build: xp float32, every other operand and output bf16
extern "C" int mvt_lstm_layer_fwd_chain_bf16(const float* xp, const mvt::bf16* h0,
                                             const mvt::bf16* c0, const mvt::bf16* u,
                                             mvt::bf16* hseq, mvt::bf16* cseq,
                                             mvt::bf16* hlast, int T, int B, int H, int act,
                                             int cluster, int rows, int splits, int stages,
                                             void* stream) {
  return mvt::chain(xp, h0, c0, u, hseq, cseq, hlast, T, B, H, act, cluster, rows, splits,
                    stages, stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float, the
// resident or the streamed slice) at `cluster` CTAs a cluster
extern "C" int mvt_lstm_layer_fwd_max_clusters(int bf16, int cluster, int stream_slice,
                                               int* out) {
  return bf16 ? mvt::fwd_max_clusters<mvt::bf16, mvt::kTanh, float>(cluster, stream_slice, out)
              : mvt::fwd_max_clusters<float, mvt::kTanh>(cluster, stream_slice, out);
}

// The per-block route: cseq (T, B, H) may be null (c not emitted); it is
// written only with emit_seq.
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
