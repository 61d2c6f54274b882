// Kernel N: one LSTM layer's backward through time (BPTT), x @ W inside.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_train.py::_lstm_bwdx_kernel
// (:2405), reached through lstm_layer_train_x's backward (_lstm_bwdx_pallas
// :2472). The TPU kernel also sums dW, db and dU over all T*B rows in VMEM;
// here that reduction is kernel W (grad_reduce.cu), over the gate grads this
// kernel emits, as in the JAX package's own wide scheme
// (_lstm_bwd_wide_kernel + _lstm_wide_weight_grads).
//
// From the forward's h and c sequences (kernel L's residuals), h0, c0 and
// the incoming grads (d_seq for return-sequence layers, d_final for last
// layers) it emits
//   dacat (T, B, 4H)   the pre-activation gate grads [di, df, dg, do], float,
//   dh0, dc0 (B, H),
//   dx (T, B, D)       = dacat @ W^T, where wanted,
// in three kernels (lstm_cell_bwd.cuh has the design and the math):
//   mvt_lstm_layer_bwd_gates  the gates' activations of every step at once,
//                             from x @ W + b + h_prev @ U (the pre-pass);
//   mvt_lstm_layer_bwd_chain  the reverse loop on thread-block clusters, U^T
//                             in the CTAs' shared memory (streamed from L2
//                             at H = 512 in float32);
//   mvt_lstm_layer_bwd_dx     dx = da @ W^T over all T*B rows.
// The wrapper (ops/lstm_layer.py::lstm_layer_bwd) runs them in order.
//
// What bounds it on the H100: the chain, T serial steps of a cluster
// barrier and a rows x 4Hc x H product per CTA, FFMA in float; the pre-pass
// and dx pass are products over all T*B rows at the FFMA rate.
//
// The bf16 build (the _bf16 entry points) runs _lstm_bwdx_kernel in a bf16
// model (row 20 in bf16): x, the stored h and c sequences, h0, c0, the
// incoming grads and the weights in bf16, each widened to float as it is
// loaded; every product sums in float (the Pallas kernel widens x,
// h_{t-1}, c_{t-1} and c_t, :2525-2526); the gate grads and the dh and dc
// carries stay float (its f32 scratch); dx, dh0 and dc0 are rounded to bf16
// once (:2491-2493). The gate grads leave unrounded in float, the values
// from which the Pallas kernel sums dW, db and dU (:2458-2460) and from
// which kernel W sums them here.
#include "lstm_cell_bwd.cuh"

namespace mvt {

template <typename TV>
int chain(const float* act, const TV* cseq, const TV* c0, const TV* d_seq, const TV* d_final,
          const TV* ut, float* dacat, TV* dh0, TV* dc0, int T, int B, int H, int cluster,
          int rows, int splits, int nbuf, int stages, int stream_slice, void* stream) {
  ChainArgs<TV> a{act, cseq, c0, d_seq, d_final, ut, dacat, nullptr, dh0, dc0,
                  T, B, H, rows, splits, nbuf, stages};
  return launch_chain(a, cluster, stream_slice, stream);
}

}  // namespace mvt

// act (T, B, 4H) float = the gates' activations of x @ W + b + h_prev @ U,
// h_prev = [h0, hseq[:-1]]; x (T, B, D), w (D, 4H), b (4H), u (H, 4H)
extern "C" int mvt_lstm_layer_bwd_gates(const float* x, const float* w, const float* b,
                                        const float* hseq, const float* h0, const float* u,
                                        float* act, int T, int B, int D, int H, void* stream) {
  return mvt::launch_gates<true>(x, w, b, hseq, h0, u, act, T, B, D, H, stream);
}

// the bf16 build, on the tensor cores, takes the weights transposed: wt =
// W^T (4H, D), ut = U^T (4H, H)
extern "C" int mvt_lstm_layer_bwd_gates_bf16(const mvt::bf16* x, const mvt::bf16* wt,
                                             const mvt::bf16* b, const mvt::bf16* hseq,
                                             const mvt::bf16* h0, const mvt::bf16* ut, float* act,
                                             int T, int B, int D, int H, void* stream) {
  return mvt::launch_gates<true>(x, wt, b, hseq, h0, ut, act, T, B, D, H, stream);
}

// The reverse loop over act: dacat (T, B, 4H) float, dh0 and dc0 (B, H).
// d_seq (T, B, H) and d_final (B, H) may each be null (read as zeros); ut =
// U^T (4H, H). cluster, rows, splits, nbuf, stages and stream_slice are
// the plan of ops/_layout.py::bptt_plan.
extern "C" int mvt_lstm_layer_bwd_chain(const float* act, const float* cseq, const float* c0,
                                        const float* d_seq, const float* d_final,
                                        const float* ut, float* dacat, float* dh0, float* dc0,
                                        int T, int B, int H, int cluster, int rows, int splits,
                                        int nbuf, int stages, int stream_slice, void* stream) {
  return mvt::chain(act, cseq, c0, d_seq, d_final, ut, dacat, dh0, dc0, T, B, H, cluster, rows,
                    splits, nbuf, stages, stream_slice, stream);
}

extern "C" int mvt_lstm_layer_bwd_chain_bf16(const float* act, const mvt::bf16* cseq,
                                             const mvt::bf16* c0, const mvt::bf16* d_seq,
                                             const mvt::bf16* d_final, const mvt::bf16* ut,
                                             float* dacat, mvt::bf16* dh0, mvt::bf16* dc0, int T,
                                             int B, int H, int cluster, int rows, int splits,
                                             int nbuf, int stages, int stream_slice, void* stream) {
  return mvt::chain(act, cseq, c0, d_seq, d_final, ut, dacat, dh0, dc0, T, B, H, cluster, rows,
                    splits, nbuf, stages, stream_slice, stream);
}

// dx (T, B, D) = da (T, B, 4H) @ W^T, wt = W^T (4H, D)
extern "C" int mvt_lstm_layer_bwd_dx(const float* da, const float* wt, float* dx, int T, int B,
                                     int D, int H, void* stream) {
  return mvt::launch_dx(da, wt, dx, T, B, D, H, stream);
}

extern "C" int mvt_lstm_layer_bwd_dx_bf16(const float* da, const mvt::bf16* wt, mvt::bf16* dx,
                                          int T, int B, int D, int H, void* stream) {
  return mvt::launch_dx(da, wt, dx, T, B, D, H, stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float, the
// resident or the streamed slice) at `cluster` CTAs a cluster
extern "C" int mvt_lstm_layer_bwd_max_clusters(int bf16, int cluster, int stream_slice,
                                               int* out) {
  return bf16 ? mvt::chain_max_clusters<mvt::bf16>(cluster, stream_slice, out)
              : mvt::chain_max_clusters<float>(cluster, stream_slice, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
