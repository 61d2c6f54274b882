// Kernel M: a whole autoregressive LSTM decode head in one kernel.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_lstm.py::
// _decode_kernel_2layer (:478) and ::_decode_kernel_1layer (:511), reached
// through fused_lstm_decode_scan (:645) from _decode_scan_pallas (:562).
// Templated on the number of LSTM layers (1 or 2), the cell activation (on g
// and on c: tanh, sigmoid or relu) and the output activation (softmax,
// sigmoid or linear). The LSTM twin of kernel B (gru_decode.cu).
//
// Per step t: the layer cells run on the previous step's activated output
// (start at t = 0), logits = h_last @ Wo + bo, probs = act(logits), and
// probs is fed back as the next input. probs and logits leave the kernel
// time-major, (T, B, D) each.
//
// Two designs, one a route chosen from the shape before any launch
// (ops/_layout.py::lstm_decode_route):
// - the decode chain on thread-block clusters (mvt_lstm_decode_chain,
//   lstm_decode_chain.cuh: each CTA H / C units of every layer, its slices
//   of [W ; U] streamed by the TMA, one product and one cluster barrier a
//   layer-step), which every serving head at H <= 512 takes;
// - the first, per-block design (mvt_lstm_decode) for shapes the chain's
//   plan refuses: one block owns kRows = 8 batch rows and runs the whole
//   time loop; the states (h and c per layer), the fed-back probs and the
//   logits of its rows live in shared memory, and the weights (W1, U1, W2,
//   U2, Wo) are re-read from L2 at every step. The h buffers rotate through
//   n_layers + 1 tiles: each cell writes its new h into the spare tile,
//   which then becomes the layer's, so one barrier ends a cell
//   (lstm_common.cuh). The output dense and the softmax over D (one warp per
//   row) are inside the loop, so nothing but the outputs touches device
//   memory.
//
// What bounds it: the serial chain of T steps, and per step an L2 read of
// every weight by every block (the chain: by every cluster).
#include "lstm_common.cuh"
#include "lstm_decode_chain.cuh"

namespace mvt {

// floats of shared memory a block of lstm_decode_kernel<NL, ...> needs: the
// fed-back probs and the logits (D each), NL + 1 h tiles and NL c tiles
inline size_t lstm_decode_smem_floats(int n_layers, int D, int H) {
  return (size_t)kRows * (2 * D + (n_layers + 1) * H + n_layers * H);
}

template <int NL, int ACT, int OUT>
__global__ void lstm_decode_kernel(
    const float* __restrict__ start, const float* __restrict__ h1_0,
    const float* __restrict__ c1_0, const float* __restrict__ h2_0,
    const float* __restrict__ c2_0,
    const float* __restrict__ w1, const float* __restrict__ u1,
    const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ u2,
    const float* __restrict__ b2,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ probs, float* __restrict__ logits,
    int T, int B, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRows;
  float* x_s = smem;                // (D, R) fed-back probs
  float* l_s = x_s + R * D;         // (D, R) logits
  float* h1_s = l_s + R * D;        // (H, R)
  float* spare = h1_s + R * H;      // (H, R)
  float* c1_s = spare + R * H;      // (H, R)
  float* h2_s = c1_s + R * H;       // (H, R), 2-layer heads only
  float* c2_s = h2_s + (NL == 2 ? R * H : 0);
  const int row0 = blockIdx.x * R;

  load_tile(start, x_s, row0, B, D);
  load_tile(h1_0, h1_s, row0, B, H);
  load_tile(c1_0, c1_s, row0, B, H);
  if constexpr (NL == 2) {
    load_tile(h2_0, h2_s, row0, B, H);
    load_tile(c2_0, c2_s, row0, B, H);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    lstm_cell<ACT>(x_s, D, h1_s, spare, c1_s, w1, u1, b1, H);
    float* done = spare;
    spare = h1_s;
    h1_s = done;
    const float* hl = h1_s;
    if constexpr (NL == 2) {
      lstm_cell<ACT>(h1_s, H, h2_s, spare, c2_s, w2, u2, b2, H);
      done = spare;
      spare = h2_s;
      h2_s = done;
      hl = h2_s;
    }
    decode_readout<OUT>(hl, wo, bo, x_s, l_s, D, H);
    // the next step's first writes to l_s and x_s come after the barrier
    // that ends its first cell, so these reads cannot race them
    store_tile(x_s, probs + (size_t)t * B * D, row0, B, D);
    store_tile(l_s, logits + (size_t)t * B * D, row0, B, D);
  }
}

template <int NL, int ACT, int OUT>
cudaError_t launch(const float* start, const float* h1_0, const float* c1_0,
                   const float* h2_0, const float* c2_0, const float* w1,
                   const float* u1, const float* b1, const float* w2,
                   const float* u2, const float* b2, const float* wo,
                   const float* bo, float* probs, float* logits, int T, int B,
                   int D, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * lstm_decode_smem_floats(NL, D, H);
  cudaError_t err = fit_block(lstm_decode_kernel<NL, ACT, OUT>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_decode_kernel<NL, ACT, OUT><<<grid, H, smem, stream>>>(
      start, h1_0, c1_0, h2_0, c2_0, w1, u1, b1, w2, u2, b2, wo, bo, probs,
      logits, T, B, D, H);
  return cudaGetLastError();
}

// The launch arguments past the template parameters, in launch's order.
struct DecodeArgs {
  const float *start, *h1_0, *c1_0, *h2_0, *c2_0, *w1, *u1, *b1, *w2, *u2,
      *b2, *wo, *bo;
  float *probs, *logits;
  int T, B, D, H;
};

template <int NL, int ACT, int OUT>
cudaError_t run(const DecodeArgs& a, cudaStream_t s) {
  return launch<NL, ACT, OUT>(a.start, a.h1_0, a.c1_0, a.h2_0, a.c2_0, a.w1,
                              a.u1, a.b1, a.w2, a.u2, a.b2, a.wo, a.bo,
                              a.probs, a.logits, a.T, a.B, a.D, a.H, s);
}

template <int NL, int ACT>
cudaError_t by_out(int out_act, const DecodeArgs& a, cudaStream_t s) {
  switch (out_act) {
    case kSoftmax: return run<NL, ACT, kSoftmax>(a, s);
    case kSigmoid: return run<NL, ACT, kSigmoid>(a, s);
    case kLinear: return run<NL, ACT, kLinear>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int NL>
cudaError_t by_act(int act, int out_act, const DecodeArgs& a, cudaStream_t s) {
  switch (act) {
    case kTanh: return by_out<NL, kTanh>(out_act, a, s);
    case kSigmoid: return by_out<NL, kSigmoid>(out_act, a, s);
    case kRelu: return by_out<NL, kRelu>(out_act, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the chain's instances: every cell and output activation, with one or two
// h tiles a layer (the plan names the count: ops/_layout.py::lstm_decode_plan)
template <int NL, int ACT, int NB>
int chain_by_out(int out_act, const LstmDecodeChainArgs& a, int cluster, void* s) {
  switch (out_act) {
    case kSoftmax: return launch_lstm_decode_chain<NL, ACT, kSoftmax, NB>(a, cluster, s);
    case kSigmoid: return launch_lstm_decode_chain<NL, ACT, kSigmoid, NB>(a, cluster, s);
    case kLinear: return launch_lstm_decode_chain<NL, ACT, kLinear, NB>(a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NL, int ACT>
int chain_by_nb(int out_act, int nb, const LstmDecodeChainArgs& a, int cluster, void* s) {
  if (nb == 1) return chain_by_out<NL, ACT, 1>(out_act, a, cluster, s);
  if (nb == 2) return chain_by_out<NL, ACT, 2>(out_act, a, cluster, s);
  return (int)cudaErrorInvalidValue;
}

template <int NL>
int chain_by_act(int act, int out_act, int nb, const LstmDecodeChainArgs& a, int cluster,
                 void* s) {
  switch (act) {
    case kTanh: return chain_by_nb<NL, kTanh>(out_act, nb, a, cluster, s);
    case kSigmoid: return chain_by_nb<NL, kSigmoid>(out_act, nb, a, cluster, s);
    case kRelu: return chain_by_nb<NL, kRelu>(out_act, nb, a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// The per-block route (the first design). h2_0, c2_0, w2, u2 and b2 are
// ignored (and may be null) when n_layers == 1.
extern "C" int mvt_lstm_decode(
    const float* start, const float* h1_0, const float* c1_0,
    const float* h2_0, const float* c2_0,
    const float* w1, const float* u1, const float* b1,
    const float* w2, const float* u2, const float* b2,
    const float* wo, const float* bo, float* probs, float* logits,
    int T, int B, int D, int H, int n_layers, int act, int out_act,
    void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || D < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const DecodeArgs a{start, h1_0, c1_0, h2_0, c2_0, w1, u1, b1, w2, u2, b2,
                     wo, bo, probs, logits, T, B, D, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers == 1) return (int)by_act<1>(act, out_act, a, s);
  if (n_layers == 2) return (int)by_act<2>(act, out_act, a, s);
  return (int)cudaErrorInvalidValue;
}

// The chain at the plan of ops/_layout.py::lstm_decode_plan: `cluster` CTAs
// a cluster, `rows` batch rows a cluster, `splits`, `stages`, `chunk` depth
// rows a chunk (32, 64 or 128, dividing H), `nb` h tiles a layer (2, or 1
// with a second cluster barrier a layer-step); every
// operand contiguous float32; s1, s2 each layer's slices of [W ; U] packed
// per CTA (LstmDecodeChainArgs::slices; ops/lstm_decode.py::
// pack_lstm_slices), 16-byte aligned; h2_0, c2_0, s2 and b2 are ignored (and
// may be null) when n_layers == 1.
extern "C" int mvt_lstm_decode_chain(
    const float* start, const float* h1_0, const float* c1_0, const float* h2_0,
    const float* c2_0, const float* s1, const float* s2, const float* b1, const float* b2,
    const float* wo, const float* bo, float* probs, float* logits,
    int T, int B, int D, int H, int n_layers, int act, int out_act,
    int cluster, int rows, int splits, int stages, int chunk, int nb, void* stream) {
  using namespace mvt;
  const bool two = n_layers == 2;
  const LstmDecodeChainArgs a{start, {h1_0, two ? h2_0 : nullptr}, {c1_0, two ? c2_0 : nullptr},
                              {s1, two ? s2 : nullptr}, {b1, two ? b2 : nullptr}, wo, bo, probs,
                              logits, T, B, D, H, rows, splits, stages, chunk};
  if (n_layers == 1) return chain_by_act<1>(act, out_act, nb, a, cluster, stream);
  if (n_layers == 2) return chain_by_act<2>(act, out_act, nb, a, cluster, stream);
  return (int)cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of the chain at `cluster` CTAs a cluster
// (one CTA an SM)
extern "C" int mvt_lstm_decode_max_clusters(int cluster, int* out) {
  using namespace mvt;
  // the whole of a block's shared memory beside the ring's mbarriers
  auto kernel = lstm_decode_chain_kernel<2, kTanh, kSoftmax, 2>;
  cudaError_t err = cluster_config(kernel, cluster, kDecSmem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, kDecSmem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
