// Kernel A: one whole GRU layer forward with the x-projection, in two
// phases on the card.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_fwdx_kernel
// (:2057, through _fwdx_pallas :2084: the (T, B, H) h sequence) and
// ::_fwdx_last_kernel (:2919, through _fwdx_last_pallas :2945: the final h
// only), reached through gru_layer_train_x (:2298) and gru_layer_infer_x
// (:2975): every GRU encoder layer in training and serving and every GRU
// judge.
//
// Design. Inside a step the TPU kernel computes xp = x_t @ W + b (:2071)
// before h @ U[:, :2H]; x_t @ W does not depend on h, so it leaves the
// serial chain:
//   1. the pre-pass (mvt_gru_layer_xproj): xp (T B, 3H) = x @ W + b over
//      all T B rows at once, stored float32, on the tensor cores
//      (xproj.cuh, kernel L's pre-pass): float32 operands through the
//      three-product TF32 split, bf16 operands as one TF32 product each
//      (the velocity layer's cast_x, D < 8, gives the same products);
//   2. the chain (mvt_gru_layer_fwd_chain): the GRU recurrence over that
//      xp on thread-block clusters (gru_cell_fwd.cuh has the design and
//      what bounds it), for every cell activation (tanh, sigmoid, relu),
//      emitting the h sequence (emit_seq = 1: training, whose backward C
//      reads it) or only the final h (serving's last layers, the branches,
//      the judges). The bf16 build reads the float xp, so x @ W + b enters
//      the gates unrounded as in _fwdx_kernel, keeps r * h in float and
//      carries h rounded to bf16 once a step (the Pallas h_s scratch and
//      seq_ref have x's dtype).
// What bounds the pre-pass is writing xp; the chain, its T steps.
//
// The first design stays as a named route for widths the chain does not
// run (ops/_layout.py::gru_fwd_route picks it, never after a failed
// launch): mvt_gru_layer_fwd, one block of kRows = 8 batch rows and H
// threads for all T steps, h in shared memory, W, U and b re-read from L2
// at every step, x_t @ W, h @ U[:, :2H] and (r * h) @ U[:, 2H:] as FFMA
// (gru_common.cuh); in bf16 every operand widened as it is loaded, r * h
// kept in float, the carried h rounded once a step. It is bound by its
// serial steps, each an L2 read of W and U by each of B / 8 blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gru_cell_fwd.cuh"
#include "xproj.cuh"

namespace mvt {

template <int ACT, typename TV>
__global__ void gru_layer_fwd_kernel(
    const TV* __restrict__ x, const TV* __restrict__ h0,
    const TV* __restrict__ w, const TV* __restrict__ b,
    const TV* __restrict__ u, TV* __restrict__ out,
    int T, int B, int D, int H, int emit_seq) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;               // (D, kRows)
  float* h_s = x_s + kRows * D;    // (H, kRows)
  float* rh_s = h_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  for (int t = 0; t < T; ++t) {
    // x_s is free: the previous step's cell ended with a barrier
    load_tile(x + (size_t)t * B * D, x_s, row0, B, D);
    __syncthreads();
    gru_cell<ACT, kRows, TV>(x_s, D, h_s, rh_s, w, u, b, H);
    if (emit_seq) {
      store_tile(h_s, out + (size_t)t * B * H, row0, B, H);
    }
  }
  if (!emit_seq) store_tile(h_s, out, row0, B, H);
}

template <int ACT, typename TV>
cudaError_t launch(const TV* x, const TV* h0, const TV* w, const TV* b,
                   const TV* u, TV* out, int T, int B, int D, int H,
                   int emit_seq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (D + 2 * H);
  cudaError_t err = fit_block(gru_layer_fwd_kernel<ACT, TV>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_layer_fwd_kernel<ACT, TV><<<grid, H, smem, stream>>>(
      x, h0, w, b, u, out, T, B, D, H, emit_seq);
  return cudaGetLastError();
}

template <typename TV>
int run(const TV* x, const TV* h0, const TV* w, const TV* b, const TV* u,
        TV* out, int T, int B, int D, int H, int act, int emit_seq,
        void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh:
      return (int)launch<kTanh>(x, h0, w, b, u, out, T, B, D, H, emit_seq, s);
    case kSigmoid:
      return (int)launch<kSigmoid>(x, h0, w, b, u, out, T, B, D, H, emit_seq, s);
    case kRelu:
      return (int)launch<kRelu>(x, h0, w, b, u, out, T, B, D, H, emit_seq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// The per-block route (see the note): every operand and output float32
extern "C" int mvt_gru_layer_fwd(
    const float* x, const float* h0, const float* w, const float* b,
    const float* u, float* out, int T, int B, int D, int H, int act,
    int emit_seq, void* stream) {
  return mvt::run(x, h0, w, b, u, out, T, B, D, H, act, emit_seq, stream);
}

extern "C" int mvt_gru_layer_fwd_bf16(
    const mvt::bf16* x, const mvt::bf16* h0, const mvt::bf16* w,
    const mvt::bf16* b, const mvt::bf16* u, mvt::bf16* out, int T, int B,
    int D, int H, int act, int emit_seq, void* stream) {
  return mvt::run(x, h0, w, b, u, out, T, B, D, H, act, emit_seq, stream);
}

// The pre-pass: x (M, K), w (K, N), b (N,) contiguous, xp (M, N) float32;
// M = T B, K = D, N = 3H.
extern "C" int mvt_gru_layer_xproj(const float* x, const float* w, const float* b, float* xp,
                                   int M, int K, int N, void* stream) {
  return mvt::xproj(x, w, b, xp, M, K, N, stream);
}

// the bf16 build: x, w, b bf16, xp float32
extern "C" int mvt_gru_layer_xproj_bf16(const mvt::bf16* x, const mvt::bf16* w,
                                        const mvt::bf16* b, float* xp, int M, int K, int N,
                                        void* stream) {
  return mvt::xproj(x, w, b, xp, M, K, N, stream);
}

namespace mvt {

template <typename TV>
int gru_chain(const float* xp, const TV* h0, const TV* u, TV* hseq, TV* hlast, int T, int B,
              int H, int act, int cluster, int rows, int splits, int stages, void* stream) {
  const GruFwdArgs<TV> a{xp, h0, u, hseq, hlast, T, B, H, rows, splits, stages};
  switch (act) {
    case kTanh: return launch_gru_fwd_chain<TV, kTanh>(a, cluster, stream);
    case kSigmoid: return launch_gru_fwd_chain<TV, kSigmoid>(a, cluster, stream);
    case kRelu: return launch_gru_fwd_chain<TV, kRelu>(a, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// The chain: xp (T, B, 3H) float32, h0 (B, H), u (H, 3H), contiguous; either
// hseq (T, B, H) or hlast (B, H). cluster, rows, splits and stages are the
// plan of ops/_layout.py::gru_fwd_plan for build "A_chain" (float32) or
// "A_chain_bf16".
extern "C" int mvt_gru_layer_fwd_chain(const float* xp, const float* h0, const float* u,
                                       float* hseq, float* hlast, int T, int B, int H, int act,
                                       int cluster, int rows, int splits, int stages,
                                       void* stream) {
  return mvt::gru_chain(xp, h0, u, hseq, hlast, T, B, H, act, cluster, rows, splits, stages,
                        stream);
}

// the bf16 build: xp float32, every other operand and output bf16
extern "C" int mvt_gru_layer_fwd_chain_bf16(const float* xp, const mvt::bf16* h0,
                                            const mvt::bf16* u, mvt::bf16* hseq,
                                            mvt::bf16* hlast, int T, int B, int H, int act,
                                            int cluster, int rows, int splits, int stages,
                                            void* stream) {
  return mvt::gru_chain(xp, h0, u, hseq, hlast, T, B, H, act, cluster, rows, splits, stages,
                        stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float, the
// resident or the streamed slice) at `cluster` CTAs a cluster
extern "C" int mvt_gru_layer_fwd_max_clusters(int bf16, int cluster, int stream_slice,
                                              int* out) {
  return bf16 ? mvt::gru_fwd_max_clusters<mvt::bf16>(cluster, stream_slice, out)
              : mvt::gru_fwd_max_clusters<float>(cluster, stream_slice, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
