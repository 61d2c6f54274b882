// Kernel E: the decode heads' backward through time, several heads in one
// launch.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_mh_bwd_kernel
// (multihead_decode_train_bwd), ::_dec_bwd1_kernel / ::_dec_bwd2_kernel
// (_dec_bwd_pallas) and ::_dec_bwd1_wide_kernel / ::_dec_bwd2_wide_kernel
// (_dec_bwd_wide_pallas, the JAX package's path at H = 512). As kernel C does
// for the encoder layers, it leaves the weight-gradient sums the in-place TPU
// kernels accumulate in VMEM to kernel W (grad_reduce.cu), the JAX package's
// wide scheme (_dec_bwd*_wide_kernel + _dec_wide_weight_grads).
//
// Per reverse step t = T-1 .. 0 of a head:
//   gp_total = g_probs[t] + dx_fed        the grad of probs[t], which fed
//                                          step t+1 (zero at t = T-1)
//   dlogits  = through softmax (reduced over D per row), sigmoid or linear,
//              plus g_logits[t]           (_dlogits_from)
//   dh_top   = dlogits @ Wo^T + the carried dh of the top layer
//   layer 2 (2-layer heads): the cell transpose on x = h1[t], h_{t-1} =
//              h2[t-1] (h2_0 at t = 0); its dx adds to layer 1's dh
//   layer 1:  the cell transpose on x = probs[t-1] (start at t = 0),
//              h_{t-1} = h1[t-1] (h1_0 at t = 0); its dx is the next dx_fed
// and emits dlogits (T, B, D), per layer da_cat (T, B, 3H) and r*h (T, B, H),
// then d_h1_0, d_h2_0 (B, H) and d_start = the last dx_fed (B, D).
//
// Two phases (gru_cell_bwd_chain.cuh has the design and the math):
//   mvt_gru_decode_bwd_gates  per layer, the gates z, r, hh of every step
//                             and r * h from its stored inputs (x and
//                             hprev = [h_0, h[:-1]], formed by the wrapper),
//                             on the tensor cores: C's pre-pass;
//   the chain entry points    one chain on thread-block clusters through
//                             the whole head: a step computes dlogits for
//                             all D columns of the cluster's rows in every
//                             CTA (no exchange for dlogits @ Wo^T over the
//                             CTA's own units: Wo's Hc rows in shared
//                             memory), then layer 2's two stages with its
//                             dx folded into the second reduction (its own
//                             units' columns go to layer 1's dh), then
//                             layer 1's with its dx (D columns) folded into
//                             the second and summed whole for the next
//                             step: 4 cluster reductions a step for a
//                             2-layer head, 2 for a 1-layer head. U1^T, U2^T
//                             and W2^T's 3 Hc rows and W1^T's (zero-padded to
//                             a multiple of 64 columns) pass through the
//                             ring: resident where it holds a step's
//                             chunks, else streamed from L2.
// The heads of a call share one launch: head k's clusters follow head
// k-1's, each head with its own rows a cluster (the plan gives the long
// notes head most of the clusters; ops/_layout.py::gru_bptt_plan).
//
// The six builds of ops/_layout.py (E, E_wide, E_resid, E_bf16,
// E_wide_row8_bf16, E_wide_bf16) run three chain entry points
// (ops/gru_decode.py::_BUILDS maps them):
//   mvt_gru_decode_bwd   float: E, E_wide, and E_resid, whose pre-pass
//       reads the h sequences stored in bf16 (rows 5 and 6 with
//       decode_residual_bf16, _mh_bwd_kernel): its wrapper widens them and
//       the unrounded initial states at t = 0, so the gates come from the
//       rounded h, and the chain is the float one;
//   mvt_gru_decode_bwd_bf16   E_bf16 and E_wide_row8_bf16: bf16 operands
//       (the stored probs and h sequences, the incoming grads, start, the
//       initial states, the weights), every sum and carry in float (layer 2
//       recomputed from the stored bf16 h1; the chain's products on the
//       tensor cores, the float da in three bf16 terms), dlogits and the
//       gate grads leave unrounded in float for kernel W (rows 7 and 8,
//       _dec_bwd1/2_kernel, which sum their weight grads from the float
//       values in VMEM);
//   mvt_gru_decode_bwd_wide_bf16   E_wide_bf16: the same, but dlogits and the gate
//       grads leave rounded to bf16 (in float), as _dec_bwd1/2_wide_kernel
//       store the streams their second pass sums (dlog_ref, dacat*_ref in
//       start's dtype, :1214-1244); the carries read the unrounded values.
// In every build d_init and d_start are rounded once to the heads' type.
//
// What bounds it: the chain, T serial steps of 2 (1-layer) or 4 (2-layer)
// dependent products and cluster barriers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (midi_vae_tpu_torch/ops/_build.py).
#include "gru_cell_bwd_chain.cuh"

// the gates of one layer of a head (C's pre-pass, this library's instance)
extern "C" int mvt_gru_decode_bwd_gates(const float* x, const float* w, const float* b,
                                        const float* hprev, const float* u, float* gates,
                                        float* rh, int M, int D, int H, void* stream) {
  return mvt::launch_gates(x, w, b, hprev, u, gates, rh, M, D, H, stream);
}

extern "C" int mvt_gru_decode_bwd_gates_bf16(const mvt::bf16* x, const mvt::bf16* w,
                                             const mvt::bf16* b, const mvt::bf16* hprev,
                                             const mvt::bf16* u, float* gates, float* rh, int M,
                                             int D, int H, void* stream) {
  return mvt::launch_gates(x, w, b, hprev, u, gates, rh, M, D, H, stream);
}

// The chain over `heads` (1 to 4): cluster, nbuf, stages and each head's
// rows and clusters are the plan of ops/_layout.py::gru_bptt_plan.
#define MVT_HEAD_CHAIN(name, TV, TG)                                                        \
  extern "C" int name(const mvt::HeadBwdChain<TV>* heads, int n_heads, int B, int H,       \
                      int cluster, int nbuf, int stages, void* stream) {                     \
    return mvt::launch_gru_head_bwd_chain<TV, TG>(heads, n_heads, B, H, cluster, nbuf,     \
                                                  stages, stream);                          \
  }

MVT_HEAD_CHAIN(mvt_gru_decode_bwd, float, float)
MVT_HEAD_CHAIN(mvt_gru_decode_bwd_bf16, mvt::bf16, float)
MVT_HEAD_CHAIN(mvt_gru_decode_bwd_wide_bf16, mvt::bf16, mvt::bf16)

// cudaOccupancyMaxActiveClusters of the chain (bf16 or float) at `cluster`
// CTAs a cluster
extern "C" int mvt_gru_decode_bwd_max_clusters(int bf16, int cluster, int* out) {
  return bf16 ? mvt::bwd_max_clusters(mvt::gru_head_bwd_chain_kernel<mvt::bf16, float>, cluster,
                                      out)
              : mvt::bwd_max_clusters(mvt::gru_head_bwd_chain_kernel<float, float>, cluster, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
