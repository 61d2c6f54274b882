// Kernel D: the decode heads' training forward.
//
// Replaces the TPU kernels midi_vae_tpu/ops/fused_train.py::_mh_fwd_kernel
// (the 2-layer notes head and every 1-layer T-length side head in one
// launch, multihead_decode_train_fwd, also with residual_dtype=bf16) and
// ::_dec_fwd1_kernel / ::_dec_fwd2_kernel (one head: _dec_fwd_pallas in
// float32 and bf16, and the batch-tiled _dec_fwd_wide_pallas the JAX package
// takes at H = 512). Those compute what the serving decode computes plus
// each layer's h sequence as the backward's residual, and so does this
// kernel; the cell activation is tanh, the one the backward (kernel E)
// implements.
//
// The design (ops/_layout.py::dec_train_route picks a head's route): one
// head a launch on kernel B's decode chain on thread-block clusters in its
// training instance (gru_decode_chain.cuh: each CTA H / C units of every
// layer, its weight slices streamed by the TMA, the h sequences stored from
// the X2 exchange), at the plan ops/_layout.py::dec_train_plan gives. The
// TPU kernel runs the heads of a multi-head call one after the other inside
// each grid step; here they are launches in turn on the caller's stream (the
// notes head's plan at B = 256 takes 120 of the 132 SMs, so the heads
// cannot share the card at their best plans). Three chain instances:
// mvt_gru_decode_train (float32: builds D and D wide), _bf16 (D bf16 and D
// wide bf16: the slices streamed in bf16, the Pallas kernel's roundings) and
// _resid (D resid, decode_residual_bf16 beside a float32 model: the float32
// instance with only the h sequences stored rounded to bf16, which halves
// the bytes kernel E reads back; its probs and logits are D's bit for bit
// at the same plan).
//
// The first, per-block designs stay the route of shapes the chain's plan
// refuses: 8 batch rows a block (mvt_gru_decode_train_block, _block_bf16,
// _block_resid: 160 registers a thread, so H <= 384) and 2 rows a block
// under __launch_bounds__(kWideThreads) for the wide builds
// (mvt_gru_decode_train_wide_block, _wide_block_bf16); their loop body is
// kernel B's first design's (decode_head in gru_decode_body.cuh) with the
// h-sequence outputs on, every head of a call in one launch (the grid's y
// dimension selects the head).
//
// What bounds it: as kernel B, the serial chain of T steps a head (two
// dependent products a layer-step and their cluster barriers), and each
// step's slices read from L2 by every cluster.
#include "gru_decode_body.cuh"
#include "gru_decode_chain.cuh"

namespace mvt {

constexpr int kMaxHeads = 4;

// one head of a launch, its tensors of type TV (float or bf16) and its h
// sequences of type TS (TV, or bf16 in the bf16-residual build); h2_0, w2,
// u2, b2 and h2seq are unused (may be null) for 1-layer heads. Mirrored by
// _DecodeHead in ops/gru_decode.py (pointers only: one layout for all).
template <typename TV, typename TS = TV>
struct DecodeHeadT {
  const TV *start, *h1_0, *h2_0, *w1, *u1, *b1, *w2, *u2, *b2, *wo, *bo;
  TV *probs, *logits;
  TS *h1seq, *h2seq;
  int D, n_layers, out_act, T;
};

template <typename TV, typename TS = TV>
struct DecodeHeads {
  DecodeHeadT<TV, TS> h[kMaxHeads];
};

template <int NL, int OUT, int R, typename TV, typename TS>
__device__ __forceinline__ void run(const DecodeHeadT<TV, TS>& a, int B, int H,
                                    float* smem) {
  decode_head<NL, kTanh, OUT, R, TV, TS>(a.start, a.h1_0, a.h2_0, a.w1, a.u1,
                                         a.b1, a.w2, a.u2, a.b2, a.wo, a.bo,
                                         a.probs, a.logits, a.h1seq, a.h2seq,
                                         a.T, B, a.D, H, smem);
}

template <int R, typename TV, typename TS>
__device__ __forceinline__ void train_heads(const DecodeHeads<TV, TS>& heads,
                                            int B, int H, float* smem) {
  const DecodeHeadT<TV, TS>& a = heads.h[blockIdx.y];
  const bool two = a.n_layers == 2;
  switch (a.out_act) {
    case kSoftmax:
      two ? run<2, kSoftmax, R>(a, B, H, smem) : run<1, kSoftmax, R>(a, B, H, smem);
      break;
    case kSigmoid:
      two ? run<2, kSigmoid, R>(a, B, H, smem) : run<1, kSigmoid, R>(a, B, H, smem);
      break;
    default:  // kLinear; the host checked the code
      two ? run<2, kLinear, R>(a, B, H, smem) : run<1, kLinear, R>(a, B, H, smem);
      break;
  }
}

template <typename TV>
__global__ void gru_decode_train_kernel(DecodeHeads<TV> heads, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  train_heads<kRows>(heads, B, H, smem);
}

// the bf16-residual build: float heads, h sequences stored in bf16
__global__ void gru_decode_train_resid_kernel(DecodeHeads<float, bf16> heads,
                                              int B, int H) {
  extern __shared__ __align__(16) float smem[];
  train_heads<kRows>(heads, B, H, smem);
}

template <typename TV>
__global__ void __launch_bounds__(kWideThreads)
    gru_decode_train_wide_kernel(DecodeHeads<TV> heads, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  train_heads<kWideRows>(heads, B, H, smem);
}

template <int R, typename TV, typename TS, typename Kernel>
int launch(Kernel kernel, const DecodeHeadT<TV, TS>* heads, int n_heads, int B,
           int H, void* stream) {
  if (n_heads < 1 || n_heads > kMaxHeads || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeHeads<TV, TS> all{};
  size_t smem = 0;
  for (int k = 0; k < n_heads; ++k) {
    const DecodeHeadT<TV, TS>& a = heads[k];
    if (a.T < 1 || a.D < 1 || (a.n_layers != 1 && a.n_layers != 2) ||
        (a.out_act != kSoftmax && a.out_act != kSigmoid && a.out_act != kLinear)) {
      return (int)cudaErrorInvalidValue;
    }
    all.h[k] = a;
    const size_t need = sizeof(float) * decode_smem_floats(a.n_layers, a.D, H, R);
    if (need > smem) smem = need;
  }
  cudaError_t err = fit_block(kernel, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + R - 1) / R, n_heads);
  kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(all, B, H);
  return (int)cudaGetLastError();
}

// One head on kernel B's decode chain (gru_decode_chain.cuh) in its
// training instance, at the plan of ops/_layout.py::dec_train_plan; `tc`
// takes the tensor-core instance (no bf16-residual one)
template <typename TV, typename TS, int NL, int OUT>
int chain_head(const GruDecodeChainArgsT<TV, TS>& a, int cluster, int tc, void* stream) {
  if constexpr (std::is_same_v<TV, TS>) {
    if (tc) return launch_gru_decode_chain_tc<NL, TV>(a, cluster, stream);
  } else {
    if (tc) return (int)cudaErrorInvalidValue;
  }
  return launch_gru_decode_chain<NL, kTanh, OUT, TV, true, TS>(a, cluster, stream);
}

template <typename TV, typename TS>
int launch_chain(const DecodeHeadT<TV, TS>* head, const TV* const* slices, int B, int H,
                 int cluster, int rows, int splits, int stages, int chunk, int tc, void* stream) {
  const DecodeHeadT<TV, TS>& h = *head;
  if (B < 1 || (h.n_layers != 1 && h.n_layers != 2)) return (int)cudaErrorInvalidValue;
  const bool two = h.n_layers == 2;
  GruDecodeChainArgsT<TV, TS> a{h.start, h.h1_0, two ? h.h2_0 : nullptr,
                                {slices[0], slices[1], slices[2], two ? slices[3] : nullptr,
                                 two ? slices[4] : nullptr, two ? slices[5] : nullptr},
                                h.b1, two ? h.b2 : nullptr, h.wo, h.bo, h.probs, h.logits,
                                h.T, B, h.D, H, rows, splits, stages, chunk,
                                {h.h1seq, two ? h.h2seq : nullptr}, h.out_act};
  switch (h.out_act) {
    case kSoftmax:
      return two ? chain_head<TV, TS, 2, kSoftmax>(a, cluster, tc, stream)
                 : chain_head<TV, TS, 1, kSoftmax>(a, cluster, tc, stream);
    case kSigmoid:
      return two ? chain_head<TV, TS, 2, kSigmoid>(a, cluster, tc, stream)
                 : chain_head<TV, TS, 1, kSigmoid>(a, cluster, tc, stream);
    case kLinear:
      return two ? chain_head<TV, TS, 2, kLinear>(a, cluster, tc, stream)
                 : chain_head<TV, TS, 1, kLinear>(a, cluster, tc, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters of a decode chain instance with the whole
// of a block's shared memory beside the ring's mbarriers
template <typename Kernel>
int chain_max_clusters(Kernel kernel, int cluster, int* out, int threads = kChainThreads) {
  cudaError_t err = cluster_config(kernel, cluster, kDecSmem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, kDecSmem, nullptr, threads);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

}  // namespace mvt

// The chain: one head a launch (its w1, u1, w2, u2 unused: slices[0..5] are
// their slices packed per CTA at the plan's cluster and chunk, of the
// build's operand type: ops/gru_decode.py::pack_slices for B's FFMA
// instance, pack_tc_slices, in B-fragment order, for the tensor-core one),
// at the plan of ops/_layout.py::dec_train_plan: `cluster` CTAs a cluster,
// `rows` batch rows a cluster, `splits` (the FFMA instance's), `stages`,
// `chunk` depth rows a chunk, `tc` the tensor-core instance;
// cudaErrorInvalidValue for a plan the chain does not run. Float32: builds
// D and D wide; bf16: D bf16 and D wide bf16; resid: D resid.
extern "C" int mvt_gru_decode_train(const mvt::DecodeHeadT<float>* head,
                                    const float* const* slices, int B, int H, int cluster,
                                    int rows, int splits, int stages, int chunk, int tc,
                                    void* stream) {
  return mvt::launch_chain(head, slices, B, H, cluster, rows, splits, stages, chunk, tc, stream);
}

extern "C" int mvt_gru_decode_train_bf16(const mvt::DecodeHeadT<mvt::bf16>* head,
                                         const mvt::bf16* const* slices, int B, int H,
                                         int cluster, int rows, int splits, int stages,
                                         int chunk, int tc, void* stream) {
  return mvt::launch_chain(head, slices, B, H, cluster, rows, splits, stages, chunk, tc, stream);
}

extern "C" int mvt_gru_decode_train_resid(const mvt::DecodeHeadT<float, mvt::bf16>* head,
                                          const float* const* slices, int B, int H, int cluster,
                                          int rows, int splits, int stages, int chunk, int tc,
                                          void* stream) {
  return mvt::launch_chain(head, slices, B, H, cluster, rows, splits, stages, chunk, tc, stream);
}

// The per-block routes, every head of a call in one launch: 8 rows a block
// (D, D bf16, D resid) and 2 rows a block (D wide, D wide bf16).
extern "C" int mvt_gru_decode_train_block(const mvt::DecodeHeadT<float>* heads, int n_heads,
                                          int B, int H, void* stream) {
  using namespace mvt;
  return launch<kRows>(gru_decode_train_kernel<float>, heads, n_heads, B, H, stream);
}

extern "C" int mvt_gru_decode_train_block_bf16(const mvt::DecodeHeadT<mvt::bf16>* heads,
                                               int n_heads, int B, int H, void* stream) {
  using namespace mvt;
  return launch<kRows>(gru_decode_train_kernel<bf16>, heads, n_heads, B, H, stream);
}

extern "C" int mvt_gru_decode_train_block_resid(
    const mvt::DecodeHeadT<float, mvt::bf16>* heads, int n_heads, int B, int H,
    void* stream) {
  using namespace mvt;
  return launch<kRows>(gru_decode_train_resid_kernel, heads, n_heads, B, H, stream);
}

extern "C" int mvt_gru_decode_train_wide_block(const mvt::DecodeHeadT<float>* heads,
                                               int n_heads, int B, int H,
                                               void* stream) {
  using namespace mvt;
  return launch<kWideRows>(gru_decode_train_wide_kernel<float>, heads, n_heads,
                           B, H, stream);
}

extern "C" int mvt_gru_decode_train_wide_block_bf16(
    const mvt::DecodeHeadT<mvt::bf16>* heads, int n_heads, int B, int H,
    void* stream) {
  using namespace mvt;
  return launch<kWideRows>(gru_decode_train_wide_kernel<bf16>, heads, n_heads,
                           B, H, stream);
}

// cudaOccupancyMaxActiveClusters of D's chain (a 2-layer
// softmax head's instance: float32 or bf16, the FFMA or the tensor-core
// one) at `cluster` CTAs a cluster (one CTA an SM)
extern "C" int mvt_gru_decode_train_max_clusters(int bf16, int tc, int cluster, int* out) {
  using namespace mvt;
  if (tc) {
    return bf16 ? chain_max_clusters(gru_decode_chain_tc_kernel<2, mvt::bf16>, cluster, out,
                                     kDecTcThreads)
                : chain_max_clusters(gru_decode_chain_tc_kernel<2, float>, cluster, out,
                                     kDecTcThreads);
  }
  return bf16 ? chain_max_clusters(gru_decode_chain_kernel<2, kTanh, kSoftmax, mvt::bf16, true>,
                                   cluster, out)
              : chain_max_clusters(gru_decode_chain_kernel<2, kTanh, kSoftmax, float, true>,
                                   cluster, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
