// Kernel F: one whole GRU layer forward (tanh) over a precomputed
// x-projection xp = x @ W + b, emitting the h sequence.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_fwd_kernel,
// reached through gru_layer_train as _fwd_pallas (grid over T) and as
// _fwd_wide_pallas (the batch-tiled grid the JAX package takes at H = 512,
// where the in-kernel-projection kernels do not fit its VMEM and it computes
// xp in XLA, :2282-2288). The port does the same at the wide route: xp is one
// torch.matmul over all T * B rows, and this kernel runs only the serial
// part.
//
// Design: kernel A's float32 chain on thread-block clusters over the given
// xp (gru_cell_fwd.cuh; a cluster owns `rows` batch rows for all T steps,
// its CTAs split the H units, a step is P1, r h exchanged, P2, h_t
// exchanged). Where a CTA's slice of U fits half of its shared memory (H =
// 256: clusters of 8) it is A's resident instance; where it does not (H =
// 512, 1024) the tensor-core instance (gru_fwd_chain_tc_kernel): the slice packed
// per CTA in B-fragment order and streamed by the Tensor Memory Accelerator
// through a ring of chunks of 32 to 128 depth rows, P1 and P2 on mma.sync as
// three TF32 products. ops/_layout.py::gru_fwd_plan and gru_tc_plan give
// the plans; the wrapper (ops/gru_layer.py::gru_layer_xp_fwd_chain) passes
// them in.
//
// The per-block route (mvt_gru_layer_xp_fwd_block, the first design: one
// block owns kRows = 8 batch rows for all T steps, h in shared memory,
// thread j reading its three gates of xp[t] from global memory and adding
// h @ U from the L2-resident U, compiled under
// __launch_bounds__(kWideThreads)) runs the widths the chain does not take
// (H = 288, 352, 416, 480 of the multiples of 32 up to 512), as
// ops/_layout.py::gru_xp_fwd_route picks before launch.
//
// What bounds the chain: T serial steps of two dependent products of rows x
// H x (2 Hc, Hc) a CTA and two cluster barriers; streamed, each step's
// chunk waits.
#include "gru_cell_fwd.cuh"

namespace mvt {

__global__ void __launch_bounds__(kWideThreads) gru_layer_xp_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ h0,
    const float* __restrict__ u, float* __restrict__ seq, int T, int B,
    int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // (H, kRows)
  float* rh_s = h_s + kRows * H;   // (H, kRows)
  const int row0 = blockIdx.x * kRows;
  load_tile(h0, h_s, row0, B, H);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    float az[kRows], ar[kRows], ah[kRows];
    load_gates(xp + (size_t)t * B * 3 * H, row0, B, H, az, ar, ah);
    // the previous step's cell ended with a barrier, and the store below
    // only reads h_s, which the next cell writes after its first barrier
    gru_cell_recurrent<kTanh>(az, ar, ah, h_s, rh_s, u, H);
    store_tile(h_s, seq + (size_t)t * B * H, row0, B, H);
  }
}

}  // namespace mvt

// The chain: xp (T, B, 3H), h0 (B, H), u (H, 3H), all float32 and
// contiguous; seq (T, B, H). cluster, rows, splits and stages are the plan
// of ops/_layout.py::gru_fwd_plan for build "F_chain" (stages 0: the slice
// resident; else A's streamed ring); cudaErrorInvalidValue for a plan the
// chain does not run.
extern "C" int mvt_gru_layer_xp_fwd(const float* xp, const float* h0, const float* u, float* seq,
                                    int T, int B, int H, int cluster, int rows, int splits,
                                    int stages, void* stream) {
  using namespace mvt;
  const GruFwdArgs<float> a{xp, h0, u, seq, nullptr, T, B, H, rows, splits, stages};
  return launch_gru_fwd_chain<float, kTanh>(a, cluster, stream);
}

// The chain's tensor-core instance (gru_cell_fwd.cuh, gru_fwd_chain_tc_kernel):
// xp, h0 and seq as above; pzr and ph the slices of U packed per CTA
// (GruFwdTcArgs; ops/gru_layer.py::pack_tc_slices), 16-byte aligned;
// cluster, rows, stages and chunk the plan of ops/_layout.py::gru_tc_plan.
extern "C" int mvt_gru_layer_xp_fwd_tc(const float* xp, const float* h0, const float* pzr,
                                       const float* ph, float* seq, int T, int B, int H,
                                       int cluster, int rows, int stages, int chunk,
                                       void* stream) {
  using namespace mvt;
  const GruFwdTcArgs<float> a{xp, h0, pzr, ph, seq, T, B, H, rows, stages, chunk};
  return launch_gru_fwd_tc<kTanh, float>(a, cluster, stream);
}

// cudaOccupancyMaxActiveClusters of the tensor-core instance at `cluster`
// CTAs a cluster (one CTA an SM)
extern "C" int mvt_gru_layer_xp_fwd_tc_max_clusters(int cluster, int* out) {
  return mvt::gru_fwd_tc_max_clusters<float>(cluster, out);
}

// The per-block route (the first design), the same operands: H a multiple
// of 32 up to 512.
extern "C" int mvt_gru_layer_xp_fwd_block(const float* xp, const float* h0,
                                          const float* u, float* seq, int T, int B,
                                          int H, void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kRows * 2 * H;
  cudaError_t err = fit_block(gru_layer_xp_fwd_kernel, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_layer_xp_fwd_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, h0, u, seq, T, B, H);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of the chain (its resident instance, or
// with stream_slice its streamed one) at `cluster` CTAs a cluster
extern "C" int mvt_gru_layer_xp_fwd_max_clusters(int stream_slice, int cluster, int* out) {
  return mvt::gru_fwd_max_clusters<float>(cluster, stream_slice, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
