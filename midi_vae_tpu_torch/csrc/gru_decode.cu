// Kernel B: a whole autoregressive GRU decode head in one launch.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_decoder.py::
// _decode_kernel_2layer and ::_decode_kernel_1layer, reached through
// fused_decode_scan. Templated on the number of GRU layers (1 or 2), the
// cell activation and the output activation (softmax, sigmoid or linear).
//
// Per step t: the layer cells run on the previous step's activated output
// (start at t = 0), logits = h_last @ Wo + bo, probs = act(logits), and
// probs is fed back as the next input. probs and logits leave the kernel
// time-major, (T, B, D) each.
//
// Two designs, one a route (ops/_layout.py::gru_decode_route, chosen from
// the shape before any launch):
// - the chain (mvt_gru_decode_chain, gru_decode_chain.cuh): a cluster of C
//   CTAs owns a group of batch rows for all T steps, each CTA a slice of the
//   units of every layer and Wo's rows of its units; the readout's partial
//   logits ride layer 2's exchange of h, so a step takes four cluster
//   barriers (two in a 1-layer head). Every serving head at H <= 512 takes
//   it (its note gives the layout and what bounds it);
// - the per-block design (mvt_gru_decode), the route of shapes the chain's
//   plan refuses: as kernel A's per-block route, one block owns kRows = 8
//   batch rows and runs the whole time loop; the GRU states, the fed-back
//   probs and the logits of its rows live in shared memory, and the weights
//   (W1, U1, W2, U2, Wo) are re-read from L2 at every step. The loop body,
//   decode_head in gru_decode_body.cuh, is shared with kernel D
//   (gru_decode_train.cu); this launch passes no h-sequence outputs. What
//   bounds it: the serial chain of T steps (2 barriers per layer and 2 for
//   the readout), and per step an L2 read of every weight by every block.
#include "gru_decode_body.cuh"
#include "gru_decode_chain.cuh"

namespace mvt {

template <int NL, int ACT, int OUT>
__global__ void gru_decode_kernel(
    const float* __restrict__ start, const float* __restrict__ h1_0,
    const float* __restrict__ h2_0,
    const float* __restrict__ w1, const float* __restrict__ u1,
    const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ u2,
    const float* __restrict__ b2,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ probs, float* __restrict__ logits,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  decode_head<NL, ACT, OUT>(start, h1_0, h2_0, w1, u1, b1, w2, u2, b2, wo, bo,
                            probs, logits, nullptr, nullptr, T, B, D, H, smem);
}

template <int NL, int ACT, int OUT>
cudaError_t launch(const float* start, const float* h1_0, const float* h2_0,
                   const float* w1, const float* u1, const float* b1,
                   const float* w2, const float* u2, const float* b2,
                   const float* wo, const float* bo, float* probs,
                   float* logits, int T, int B, int D, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * decode_smem_floats(NL, D, H);
  cudaError_t err = fit_block(gru_decode_kernel<NL, ACT, OUT>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_decode_kernel<NL, ACT, OUT><<<grid, H, smem, stream>>>(
      start, h1_0, h2_0, w1, u1, b1, w2, u2, b2, wo, bo, probs, logits,
      T, B, D, H);
  return cudaGetLastError();
}

template <int NL, int ACT>
cudaError_t by_out(int out_act, const float* start, const float* h1_0,
                   const float* h2_0, const float* w1, const float* u1,
                   const float* b1, const float* w2, const float* u2,
                   const float* b2, const float* wo, const float* bo,
                   float* probs, float* logits, int T, int B, int D, int H,
                   cudaStream_t s) {
  switch (out_act) {
    case kSoftmax:
      return launch<NL, ACT, kSoftmax>(start, h1_0, h2_0, w1, u1, b1, w2, u2,
                                       b2, wo, bo, probs, logits, T, B, D, H, s);
    case kSigmoid:
      return launch<NL, ACT, kSigmoid>(start, h1_0, h2_0, w1, u1, b1, w2, u2,
                                       b2, wo, bo, probs, logits, T, B, D, H, s);
    case kLinear:
      return launch<NL, ACT, kLinear>(start, h1_0, h2_0, w1, u1, b1, w2, u2,
                                      b2, wo, bo, probs, logits, T, B, D, H, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int NL>
cudaError_t by_act(int act, int out_act, const float* start, const float* h1_0,
                   const float* h2_0, const float* w1, const float* u1,
                   const float* b1, const float* w2, const float* u2,
                   const float* b2, const float* wo, const float* bo,
                   float* probs, float* logits, int T, int B, int D, int H,
                   cudaStream_t s) {
  switch (act) {
    case kTanh:
      return by_out<NL, kTanh>(out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                               b2, wo, bo, probs, logits, T, B, D, H, s);
    case kSigmoid:
      return by_out<NL, kSigmoid>(out_act, start, h1_0, h2_0, w1, u1, b1, w2,
                                  u2, b2, wo, bo, probs, logits, T, B, D, H, s);
    case kRelu:
      return by_out<NL, kRelu>(out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                               b2, wo, bo, probs, logits, T, B, D, H, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int NL, int ACT>
int chain_by_out(int out_act, const GruDecodeChainArgs& a, int cluster, void* s) {
  switch (out_act) {
    case kSoftmax: return launch_gru_decode_chain<NL, ACT, kSoftmax>(a, cluster, s);
    case kSigmoid: return launch_gru_decode_chain<NL, ACT, kSigmoid>(a, cluster, s);
    case kLinear: return launch_gru_decode_chain<NL, ACT, kLinear>(a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NL>
int chain_by_act(int act, int out_act, const GruDecodeChainArgs& a, int cluster, void* s) {
  switch (act) {
    case kTanh: return chain_by_out<NL, kTanh>(out_act, a, cluster, s);
    case kSigmoid: return chain_by_out<NL, kSigmoid>(out_act, a, cluster, s);
    case kRelu: return chain_by_out<NL, kRelu>(out_act, a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// h2_0, w2, u2 and b2 are ignored (and may be null) when n_layers == 1.
extern "C" int mvt_gru_decode(
    const float* start, const float* h1_0, const float* h2_0,
    const float* w1, const float* u1, const float* b1,
    const float* w2, const float* u2, const float* b2,
    const float* wo, const float* bo, float* probs, float* logits,
    int T, int B, int D, int H, int n_layers, int act, int out_act,
    void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers == 1) {
    return (int)by_act<1>(act, out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                          b2, wo, bo, probs, logits, T, B, D, H, s);
  }
  if (n_layers == 2) {
    return (int)by_act<2>(act, out_act, start, h1_0, h2_0, w1, u1, b1, w2, u2,
                          b2, wo, bo, probs, logits, T, B, D, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The chain at the plan of ops/_layout.py::gru_decode_plan: `cluster` CTAs
// a cluster, `rows` batch rows a cluster, `splits`, `stages`, `chunk`
// depth rows a chunk (32, 64 or 128, dividing H); every operand
// contiguous float32; s0..s5 the weights' slices packed per CTA
// (GruDecodeChainArgs::slices; ops/gru_decode.py::pack_slices), 16-byte
// aligned; h2_0, s3..s5 and b2 are ignored (and may be null) when
// n_layers == 1.
extern "C" int mvt_gru_decode_chain(
    const float* start, const float* h1_0, const float* h2_0,
    const float* s0, const float* s1, const float* s2,
    const float* s3, const float* s4, const float* s5,
    const float* b1, const float* b2, const float* wo, const float* bo,
    float* probs, float* logits,
    int T, int B, int D, int H, int n_layers, int act, int out_act,
    int cluster, int rows, int splits, int stages, int chunk, void* stream) {
  using namespace mvt;
  const GruDecodeChainArgs a{start, h1_0, h2_0, {s0, s1, s2, s3, s4, s5}, b1, b2, wo, bo, probs,
                             logits, T, B, D, H, rows, splits, stages, chunk};
  if (n_layers == 1) return chain_by_act<1>(act, out_act, a, cluster, stream);
  if (n_layers == 2) return chain_by_act<2>(act, out_act, a, cluster, stream);
  return (int)cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of the chain at `cluster` CTAs a cluster
// (one CTA an SM)
extern "C" int mvt_gru_decode_max_clusters(int cluster, int* out) {
  using namespace mvt;
  // the whole of a block's shared memory beside the ring's mbarriers
  auto kernel = gru_decode_chain_kernel<2, kTanh, kSoftmax>;
  cudaError_t err = cluster_config(kernel, cluster, kDecSmem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, kDecSmem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
