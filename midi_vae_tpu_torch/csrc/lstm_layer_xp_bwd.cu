// Kernel R: one LSTM layer's backward through time (BPTT) over a
// precomputed x-projection: the gate grads, which are dL/dxp.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_lstm_bwd_kernel
// (:1383, through _lstm_bwd_pallas :1448, which also sums dU in VMEM) and
// ::_lstm_bwd_wide_kernel (:1922, through _lstm_bwd_wide_pallas :1984, the
// batch-tiled two-pass variant with dU reduced afterwards in XLA by
// _lstm_wide_weight_grads :2032). Here dU = h_{t-1}^T . da is always that
// second pass, kernel W (grad_reduce.cu), over this kernel's gate grads.
//
// From xp (T, B, 4H), the forward's h and c sequences (kernel Q's), h0, c0
// and the incoming grads (d_seq for return-sequence layers, d_final for last
// layers) it emits dacat (T, B, 4H) = [di, df, dg, do], which is dxp, and
// dh0, dc0 (B, H), in two kernels (lstm_cell_bwd.cuh has the design and the
// math):
//   mvt_lstm_layer_xp_bwd_gates  the gates' activations of every step at
//                                once, from xp + h_prev @ U (the pre-pass);
//   mvt_lstm_layer_xp_bwd_chain  the reverse loop on thread-block clusters,
//                                U^T in the CTAs' shared memory (streamed
//                                from L2 at H = 512 in float32).
// dx = dxp @ W^T, dW and db are torch.matmul / autograd over
// xp = x @ W + b, outside any kernel, as in the JAX package. The wrapper
// (ops/lstm_layer.py::lstm_layer_xp_bwd) runs the two in order.
//
// What bounds it on the H100: the chain, T serial steps of a cluster
// barrier and a rows x 4Hc x H product per CTA, FFMA in float; the pre-pass
// is a product over all T*B rows at the FFMA rate.
//
// The bf16 build (the _bf16 entry points) runs _lstm_bwd_wide_kernel and
// _lstm_bwd_kernel in a bf16 model (rows 18 and 16 in bf16): xp, the stored
// h and c sequences, h0, c0, the incoming grads and U in bf16, each widened
// to float as it is loaded; every product sums in float, the gate grads
// and the dh and dc carries stay float. It emits dxp rounded to bf16
// (dacat_ref and dxp_ref in xp's dtype, :2000, :1435) with dh0 and dc0
// rounded, and, where dacat is not null, the same gate grads unrounded in
// float. Row 18 sums dU from the rounded stream (_lstm_wide_weight_grads
// :2032-2043, after the kernel), so kernel W reads dxp there; row 16 sums
// dU inside the kernel from the unrounded da (:1436), so kernel W reads
// dacat there. The float build emits dacat alone, which is its dxp.
#include "lstm_cell_bwd.cuh"

// act (T, B, 4H) float = the gates' activations of xp + h_prev @ U,
// h_prev = [h0, hseq[:-1]]; xp (T, B, 4H), u (H, 4H)
extern "C" int mvt_lstm_layer_xp_bwd_gates(const float* xp, const float* hseq, const float* h0,
                                           const float* u, float* act, int T, int B, int H,
                                           void* stream) {
  return mvt::launch_gates<false>(xp, nullptr, nullptr, hseq, h0, u, act, T, B, 0, H, stream);
}

// the bf16 build, on the tensor cores, takes ut = U^T (4H, H)
extern "C" int mvt_lstm_layer_xp_bwd_gates_bf16(const mvt::bf16* xp, const mvt::bf16* hseq,
                                                const mvt::bf16* h0, const mvt::bf16* ut,
                                                float* act, int T, int B, int H, void* stream) {
  return mvt::launch_gates<false>(xp, nullptr, nullptr, hseq, h0, ut, act, T, B, 0, H, stream);
}

// The reverse loop over act: dacat (T, B, 4H) float (the float build's
// dxp; the bf16 build's may be null), dh0 and dc0 (B, H); d_seq (T, B, H)
// and d_final (B, H) may each be null (read as zeros); ut = U^T (4H, H).
// cluster, rows, splits, nbuf, stages and stream_slice are the plan of
// ops/_layout.py::bptt_plan.
extern "C" int mvt_lstm_layer_xp_bwd_chain(const float* act, const float* cseq, const float* c0,
                                           const float* d_seq, const float* d_final,
                                           const float* ut, float* dacat, float* dh0, float* dc0,
                                           int T, int B, int H, int cluster, int rows, int splits,
                                           int nbuf, int stages, int stream_slice, void* stream) {
  mvt::ChainArgs<float> a{act, cseq, c0, d_seq, d_final, ut, dacat, nullptr, dh0, dc0,
                          T, B, H, rows, splits, nbuf, stages};
  return mvt::launch_chain(a, cluster, stream_slice, stream);
}

// the bf16 build: dxp (bf16) receives the rounded gate grads, dacat (float,
// may be null) the same gate grads unrounded
extern "C" int mvt_lstm_layer_xp_bwd_chain_bf16(
    const float* act, const mvt::bf16* cseq, const mvt::bf16* c0, const mvt::bf16* d_seq,
    const mvt::bf16* d_final, const mvt::bf16* ut, float* dacat, mvt::bf16* dxp,
    mvt::bf16* dh0, mvt::bf16* dc0, int T, int B, int H, int cluster, int rows, int splits,
    int nbuf, int stages, int stream_slice, void* stream) {
  if (dxp == nullptr) return (int)cudaErrorInvalidValue;
  mvt::ChainArgs<mvt::bf16> a{act, cseq, c0, d_seq, d_final, ut, dacat, dxp, dh0, dc0,
                              T, B, H, rows, splits, nbuf, stages};
  return mvt::launch_chain(a, cluster, stream_slice, stream);
}

// cudaOccupancyMaxActiveClusters of the chain's build (bf16 or float, the
// resident or the streamed slice) at `cluster` CTAs a cluster
extern "C" int mvt_lstm_layer_xp_bwd_max_clusters(int bf16, int cluster, int stream_slice,
                                                  int* out) {
  return bf16 ? mvt::chain_max_clusters<mvt::bf16>(cluster, stream_slice, out)
              : mvt::chain_max_clusters<float>(cluster, stream_slice, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
