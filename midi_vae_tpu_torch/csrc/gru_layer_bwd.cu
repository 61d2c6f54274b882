// Kernel C: one GRU layer's backward through time (BPTT), x @ W recomputed.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_bwdx_kernel
// (:2116), reached through gru_layer_train_x's backward (_bwdx_pallas
// :2201). The TPU kernel also sums dW, db and dU over all T*B rows in VMEM;
// here that reduction is kernel W (grad_reduce.cu), over the gate grads and
// r * h this kernel emits, as in the JAX package's own wide scheme
// (_bwd_wide_kernel + _gru_wide_weight_grads).
//
// From x, hprev = [h0, hseq[:-1]] (the forward's h sequence shifted by one
// step; the wrapper forms it, and hands it to kernel W too), the incoming
// grads (d_seq for return-sequence layers, d_final for last layers) and the
// weights it emits
//   dacat (T, B, 3H)   the pre-activation gate grads [da_z, da_r, da], float,
//   rh (T, B, H)       r * h_{t-1}, the dU[:, 2H:] operand of kernel W,
//   dh0 (B, H),
//   dx (T, B, D)       = dacat @ W^T, where wanted (not the first layer),
// in three phases (gru_cell_bwd_chain.cuh has the design and the math):
//   mvt_gru_layer_bwd_gates  the gates z, r, hh of every step at once and
//                            r * h (the pre-pass, two products on the
//                            tensor cores);
//   mvt_gru_layer_bwd_chain  the reverse loop on thread-block clusters, two
//                            cluster reductions a step, U^T's 3 Hc rows a
//                            CTA in shared memory (streamed from L2 where
//                            they do not fit);
//   mvt_gru_layer_bwd_dx     dx = dacat @ W^T over all T*B rows (tensor
//                            cores).
// The wrapper (ops/gru_layer.py::gru_layer_bwd) runs them in order.
//
// What bounds it on the H100: the chain, T serial steps of two dependent
// products of rows x Hc x H (and 2 Hc x H) a CTA and two cluster barriers;
// the pre-pass and the dx pass are products over all T*B rows at the
// tensor cores' rate.
//
// The bf16 build (the _bf16 entry points) runs _bwdx_kernel in a bf16 model:
// x, the stored h sequence, h0, the incoming grads and the weights in bf16;
// the pre-pass takes the bf16 products exactly (r * h in float, split in
// two against U_h), the chain takes da . U^T on the tensor cores with the
// float da in three bf16 terms and keeps every gate grad and the dh carry in
// float, as the Pallas kernel (its f32 scratch); dx and dh0 are rounded to
// bf16 once (:2212-2213), the gate grads and r * h leave in float for kernel
// W. The velocity layer's cast_x
// (D < 8: W widened to float32 in _bwdx_pallas :2208) multiplies the same
// numbers, so it takes this build.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gru_cell_bwd_chain.cuh"

namespace mvt {

template <typename TV>
int chain(const float* gates, const TV* hprev, const TV* d_seq, const TV* d_final, const TV* ut,
          float* dacat, TV* dh0, int T, int B, int H, int cluster, int rows, int nbuf,
          int stages, void* stream) {
  const GruBwdChainArgs<TV> a{gates, hprev, d_seq, d_final, ut, dacat, dh0,
                              T, B, H, rows, nbuf, stages};
  return launch_gru_bwd_chain(a, cluster, stream);
}

}  // namespace mvt

// gates (M, 3H) float = [z, r, hh] and rh (M, H) float of x (M, D) @ w (D,
// 3H) + b (3H) and hprev (M, H) @ u (H, 3H); M = T B
extern "C" int mvt_gru_layer_bwd_gates(const float* x, const float* w, const float* b,
                                       const float* hprev, const float* u, float* gates,
                                       float* rh, int M, int D, int H, void* stream) {
  return mvt::launch_gates(x, w, b, hprev, u, gates, rh, M, D, H, stream);
}

extern "C" int mvt_gru_layer_bwd_gates_bf16(const mvt::bf16* x, const mvt::bf16* w,
                                            const mvt::bf16* b, const mvt::bf16* hprev,
                                            const mvt::bf16* u, float* gates, float* rh, int M,
                                            int D, int H, void* stream) {
  return mvt::launch_gates(x, w, b, hprev, u, gates, rh, M, D, H, stream);
}

// The reverse loop over the gates: dacat (T, B, 3H) float and dh0 (B, H).
// d_seq (T, B, H) and d_final (B, H) may each be null (read as zeros); ut =
// U^T (3H, H). cluster, rows, nbuf and stages are the plan of
// ops/_layout.py::gru_bptt_plan.
extern "C" int mvt_gru_layer_bwd_chain(const float* gates, const float* hprev,
                                       const float* d_seq, const float* d_final, const float* ut,
                                       float* dacat, float* dh0, int T, int B, int H, int cluster,
                                       int rows, int nbuf, int stages, void* stream) {
  return mvt::chain(gates, hprev, d_seq, d_final, ut, dacat, dh0, T, B, H, cluster, rows, nbuf,
                    stages, stream);
}

extern "C" int mvt_gru_layer_bwd_chain_bf16(const float* gates, const mvt::bf16* hprev,
                                            const mvt::bf16* d_seq, const mvt::bf16* d_final,
                                            const mvt::bf16* ut, float* dacat, mvt::bf16* dh0,
                                            int T, int B, int H, int cluster, int rows, int nbuf,
                                            int stages, void* stream) {
  return mvt::chain(gates, hprev, d_seq, d_final, ut, dacat, dh0, T, B, H, cluster, rows, nbuf,
                    stages, stream);
}

// dx (M, D) = dacat (M, 3H) @ W^T, wt = W^T (3H, D)
extern "C" int mvt_gru_layer_bwd_dx(const float* dacat, const float* wt, float* dx, int M, int D,
                                    int H, void* stream) {
  return mvt::launch_bwd_dx(dacat, wt, dx, M, D, H, stream);
}

extern "C" int mvt_gru_layer_bwd_dx_bf16(const float* dacat, const mvt::bf16* wt, mvt::bf16* dx,
                                         int M, int D, int H, void* stream) {
  return mvt::launch_bwd_dx(dacat, wt, dx, M, D, H, stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float) at
// `cluster` CTAs a cluster
extern "C" int mvt_gru_layer_bwd_max_clusters(int bf16, int cluster, int* out) {
  return bf16 ? mvt::bwd_max_clusters(mvt::gru_bwd_chain_kernel<mvt::bf16>, cluster, out)
              : mvt::bwd_max_clusters(mvt::gru_bwd_chain_kernel<float>, cluster, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
