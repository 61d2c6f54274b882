// Kernel X: one whole GRU encoder layer in bf16 over a precomputed
// x-projection xp = x @ W + b, emitting the h sequence or only the final h.
//
// Replaces the TPU kernel midi_vae_tpu/ops/fused_decoder.py::_encoder_kernel
// (:288), reached through _encoder_scan_pallas (:347, grid over T) and
// _encoder_scan_wide_pallas (:416, the batch-tiled grid taken where
// _encoder_vmem_ok fails: GRU(512) at B = 512) from fused_encoder_scan
// (:457). The JAX package runs it for bf16 training with
// fused_train_encoder=False (models/vae.py:255-260, models/rnn.py:165-182),
// and its _fwd_kernel in bf16 computes the same function (row 9 in a bf16
// model, gru_layer_xp); its backward is no kernel: _fes_bwd (:492)
// recomputes the plain scan under jax.vjp, and the port's autograd Function
// does the same (ops/encoder_scan.py).
//
// Numerics, as the Pallas kernel's: xp, h0, U and the output are bf16; the
// products h @ U and (r * h) @ U_h and the gate math run in float (r * h
// stays float, which is what the Pallas dot promotes it to), and h is
// rounded to bf16 after every step (h_s[:] = new_h.astype(h_s.dtype), :311).
// The cell activation is tanh, sigmoid or relu (_activation); the h
// sequence or the final h is emitted.
//
// Design: kernel A's bf16 GRU chain on thread-block clusters
// (gru_cell_fwd.cuh, gru_fwd_chain_mma_kernel) in its bf16-xp instance: a
// cluster owns a group of batch rows for all T steps, its CTAs split the H
// units and keep their slice of U in shared memory; a step is P1 (h . U_zr
// on the tensor cores over the bf16 h tile, xp's z and r columns widened
// in the epilogue), r * h pushed to every peer, one cluster barrier, P2
// ((r h) . U_h, FFMA over the slice, xp's candidate widened), h_t pushed to
// every peer, one cluster barrier. The plan (cluster size, rows, splits) is
// X's own (ops/_layout.py::gru_fwd_plan("X_chain", ...): A bf16's rules at
// the largest cluster that holds the slice), passed in by the wrapper
// (ops/encoder_scan.py).
//
// Where no cluster holds the bf16 slice in its CTAs' shared memory (H =
// 1024: 384 KiB a CTA in clusters of 16), X runs F's tensor-core instance
// in its bf16 build (gru_cell_fwd.cuh, gru_fwd_chain_tc_kernel<ACT, bf16>:
// the slice packed per CTA in B-fragment order, ops/gru_layer.py::
// pack_tc_slices, and streamed by the Tensor Memory Accelerator; P1 one
// TF32 product of the exact bf16 operands, P2 two, r h split beside the
// exact U_h; h rounded to bf16 once a step), at the plan of ops/_layout.py::
// gru_tc_plan(..., elem=2) (mvt_gru_encoder_scan_tc).
//
// The per-block route (mvt_gru_encoder_scan_block, the first design: kernel
// F over bf16 operands, one block of H threads per kRows = 8 batch rows, U
// read from L2 at every step) runs the widths the chain does not take
// (its CTA's slice of U needs H / C a multiple of 32 within half a block's
// shared memory: H = 160, 224, 288, ...), as ops/_layout.py::
// gru_scan_route picks before launch. It is compiled under
// __launch_bounds__(kWideThreads), so a block of up to 512 threads (H <=
// 512) always has the registers it needs.
//
// What bounds the chain: T serial steps of two dependent products of rows x
// H x (2 Hc, Hc) a CTA and two cluster barriers.
#include "gru_cell_fwd.cuh"

namespace mvt {

// The per-block route: one block owns kRows = 8 batch rows for all T steps,
// h (bf16 values held in float) and r * h of its rows in shared memory;
// thread j reads its three gates of xp[t] from global memory and adds h @ U
// from the L2-resident U.
template <int ACT, bool SEQ>
__global__ void __launch_bounds__(kWideThreads) gru_encoder_scan_kernel(
    const bf16* __restrict__ xp, const bf16* __restrict__ h0,
    const bf16* __restrict__ u, bf16* __restrict__ out, int T, int B,
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
    gru_cell_recurrent<ACT, kRows, bf16, bf16>(az, ar, ah, h_s, rh_s, u, H);
    if constexpr (SEQ) store_tile(h_s, out + (size_t)t * B * H, row0, B, H);
  }
  if constexpr (!SEQ) store_tile(h_s, out, row0, B, H);
}

template <int ACT, bool SEQ>
cudaError_t launch(const bf16* xp, const bf16* h0, const bf16* u, bf16* out,
                   int T, int B, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * 2 * H;
  cudaError_t err = fit_block(gru_encoder_scan_kernel<ACT, SEQ>, H, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_encoder_scan_kernel<ACT, SEQ><<<grid, H, smem, stream>>>(xp, h0, u, out,
                                                               T, B, H);
  return cudaGetLastError();
}

template <bool SEQ>
cudaError_t launch_act(const bf16* xp, const bf16* h0, const bf16* u,
                       bf16* out, int T, int B, int H, int act,
                       cudaStream_t stream) {
  switch (act) {
    case kTanh:
      return launch<kTanh, SEQ>(xp, h0, u, out, T, B, H, stream);
    case kSigmoid:
      return launch<kSigmoid, SEQ>(xp, h0, u, out, T, B, H, stream);
    case kRelu:
      return launch<kRelu, SEQ>(xp, h0, u, out, T, B, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mvt

// The chain: xp (T, B, 3H), h0 (B, H), u (H, 3H), all bf16 and contiguous;
// out is (T, B, H) with return_sequences, else (B, H). cluster, rows,
// splits and stages are the plan of ops/_layout.py::gru_fwd_plan for build
// "X_chain".
extern "C" int mvt_gru_encoder_scan(const mvt::bf16* xp, const mvt::bf16* h0,
                                    const mvt::bf16* u, mvt::bf16* out, int T,
                                    int B, int H, int act, int return_sequences,
                                    int cluster, int rows, int splits, int stages,
                                    void* stream) {
  using namespace mvt;
  const GruFwdArgs<bf16, bf16> a{xp, h0, u, return_sequences ? out : nullptr,
                                 return_sequences ? nullptr : out, T, B, H,
                                 rows, splits, stages};
  switch (act) {
    case kTanh: return launch_gru_fwd_chain<bf16, kTanh, bf16>(a, cluster, stream);
    case kSigmoid: return launch_gru_fwd_chain<bf16, kSigmoid, bf16>(a, cluster, stream);
    case kRelu: return launch_gru_fwd_chain<bf16, kRelu, bf16>(a, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The streamed instance: xp and h0 as above, out the (T, B, H) sequence
// (the wrapper takes the final h from it); pzr and ph U's slices packed per
// CTA (GruFwdTcArgs; ops/gru_layer.py::pack_tc_slices), bf16 and 16-byte
// aligned; cluster, rows, stages and chunk the plan of ops/_layout.py::
// gru_tc_plan(..., elem=2).
extern "C" int mvt_gru_encoder_scan_tc(const mvt::bf16* xp, const mvt::bf16* h0,
                                       const mvt::bf16* pzr, const mvt::bf16* ph, mvt::bf16* out,
                                       int T, int B, int H, int act, int cluster, int rows,
                                       int stages, int chunk, void* stream) {
  using namespace mvt;
  const GruFwdTcArgs<bf16> a{xp, h0, pzr, ph, out, T, B, H, rows, stages, chunk};
  switch (act) {
    case kTanh: return launch_gru_fwd_tc<kTanh, bf16>(a, cluster, stream);
    case kSigmoid: return launch_gru_fwd_tc<kSigmoid, bf16>(a, cluster, stream);
    case kRelu: return launch_gru_fwd_tc<kRelu, bf16>(a, cluster, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters of the streamed instance at `cluster` CTAs
// a cluster
extern "C" int mvt_gru_encoder_scan_tc_max_clusters(int cluster, int* out) {
  return mvt::gru_fwd_tc_max_clusters<mvt::bf16>(cluster, out);
}

// The per-block route, the same operands: H a multiple of 32 up to 512.
extern "C" int mvt_gru_encoder_scan_block(const mvt::bf16* xp, const mvt::bf16* h0,
                                          const mvt::bf16* u, mvt::bf16* out, int T,
                                          int B, int H, int act,
                                          int return_sequences, void* stream) {
  using namespace mvt;
  if (T < 1 || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(return_sequences
                   ? launch_act<true>(xp, h0, u, out, T, B, H, act, s)
                   : launch_act<false>(xp, h0, u, out, T, B, H, act, s));
}

// cudaOccupancyMaxActiveClusters of the chain (the bf16 build's bf16-xp
// instance; bf16 must be 1) at `cluster` CTAs a cluster
extern "C" int mvt_gru_encoder_scan_max_clusters(int bf16, int cluster, int* out) {
  if (!bf16) return (int)cudaErrorInvalidValue;
  return mvt::gru_fwd_max_clusters<mvt::bf16, mvt::bf16>(cluster, 0, out);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
