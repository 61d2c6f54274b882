// Kernel E: the serial part of the decode heads' backward, several heads in
// one launch.
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
// Design: the grid's y dimension selects the head, as in kernel D; within a
// head, kernel C's layout (gru_cell_bwd.cuh): one block owns R batch rows,
// thread j owns hidden column j, the dh carries stay in registers and the
// tiles in shared memory. The softmax transpose is one warp per row over the
// D real columns (no padding lanes).
//
// Two builds of the same body, as kernel D: the narrow one
// (mvt_gru_decode_bwd) holds kRows = 8 rows per block at 168 registers a
// thread (up to H = 384 threads); the wide one (mvt_gru_decode_bwd_wide)
// holds kWideRows = 2 under __launch_bounds__(kWideThreads), so H = 512
// threads launch, and its shared tile, 2 x (3D + 8H) floats, stays far
// under the 227 KB a block may have. At the 128-register cap the wide build
// still spills (192 bytes a thread; 344 at 4 rows a block, where the notes
// head's backward took 98 ms against 71 ms at 2 rows on the H100): two
// columns a thread (blockDim = H / 2, 255 registers) is the next layout.
//
// What bounds it: the serial chain of T steps, per step and layer 4 barriers
// and two L2 reads of the layer's W and U, by each of the B/R blocks.
//
// The narrow build has a bf16 twin (mvt_gru_decode_bwd_bf16) for a bf16
// model (_dec_bwd1/2_kernel in bf16): the stored probs and h sequences, the
// incoming grads, start, the initial states and the weights are bf16,
// widened to float as they are loaded; the whole transpose runs in float
// (layer 2 recomputed from the stored bf16 h1, the dh carries and the grad
// of the fed-back probs in float), dlogits, the gate grads and r * h leave
// in float for kernel W, and d_init and d_start are rounded to bf16 once.
//
// The wide build has a bf16 twin too (mvt_gru_decode_bwd_wide_bf16), for a
// bf16 model at H = 512, where the JAX package runs _dec_bwd1/2_wide_kernel
// in bf16 (_dec_bwd_wide_pallas) and sums the weight grads in a second pass
// (_dec_wide_weight_grads): the same float transpose as the narrow bf16
// build, but the streams that pass reads are stored as the TPU stores them,
// rounded to bf16 (dlog_ref, dacat*_ref in start's dtype, :1214-1244):
// dlogits and each layer's gate grads leave as bf16 values in float, which
// kernel W then sums in float. The carries read the unrounded values, as
// the Pallas kernels do; r * h stays float (pass 2 recomputes r in float).
//
// The wide bf16 build has a second twin with row 8's rounding
// (mvt_gru_decode_bwd_wide_row8_bf16), for a bf16 model whose head the JAX
// package runs through _dec_bwd1/2_kernel (rows 7 and 8: _dec_train_vmem_ok
// admits it, e.g. a 1-layer head at B <= 128, H = 512) at a width where the
// 8-row bf16 build does not launch (167 registers a thread): the 2-row
// layout under __launch_bounds__(kWideThreads), with dlogits and the gate
// grads left unrounded, as the narrow bf16 build leaves them and as
// _dec_bwd1/2_kernel sums its weight grads from the float values in VMEM.
// Its forward is the wide D's bf16 build: _dec_fwd1/2_kernel is the forward
// of rows 7 and 13 alike, on the untiled or the batch-tiled grid.
//
// The narrow float build has a bf16-residual twin (mvt_gru_decode_bwd_resid)
// for a float32 model with decode_residual_bf16 (_mh_bwd_kernel reading
// h1seq, h2seq and hkseq stored in bf16): the weights, probs, incoming
// grads and initial states are float, the h sequences bf16, and the gates
// are recomputed from the rounded h, as _mh_bwd_kernel does: h_{t-1} is the
// rounded h[t-1] (the unrounded initial state at t = 0), layer 1's x the
// float probs, layer 2's x the rounded h1[t]; r * h comes from the rounded
// h_{t-1}. Kernel W then sums dWo and layer 2's dW over the rounded h
// sequences (W's bf16 build), as _mh_bwd_kernel's in-kernel sums do.
#include "gru_cell_bwd.cuh"

namespace mvt {

constexpr int kMaxHeads = 4;

// one head of a launch, (T, B, .) sequences time-major; the layer-2 fields
// are unused (may be null) for 1-layer heads. ut = U^T (3H, H), wt = W^T
// (3H, D_in), wot = Wo^T (D, H). TV is float, or bf16 in the bf16 builds;
// the h sequences are of type TS (TV, or bf16 in the bf16-residual build);
// dlogits, the gate grads and r * h are float in all. Mirrored by
// _DecodeHeadBwd in ops/gru_decode.py (pointers only: one layout for all).
template <typename TV, typename TS = TV>
struct DecodeHeadBwdT {
  const TV* probs;
  const TS *h1seq, *h2seq;
  const TV *g_probs, *g_logits, *start, *h1_0, *h2_0;
  const TV *w1, *u1, *b1, *u1t, *w1t, *w2, *u2, *b2, *u2t, *w2t, *wot;
  float *dlogits, *da1, *rh1, *da2, *rh2;
  TV *d_h1_0, *d_h2_0, *d_start;
  int D, n_layers, out_act, T;
};

template <typename TV, typename TS = TV>
struct DecodeHeadsBwd {
  DecodeHeadBwdT<TV, TS> h[kMaxHeads];
};

inline size_t bwd_smem_floats(int D, int H, int rows) {
  return (size_t)rows * (3 * D + 8 * H);
}

// TG: the type the emitted dlogits and gate grads are rounded as (float, or
// bf16 in the wide bf16 build); they are stored in float either way
template <int NL, int OUT, int R, typename TV, typename TG, typename TS>
__device__ __forceinline__ void decode_head_bwd(
    const DecodeHeadBwdT<TV, TS>& a, int B, int H, float* smem) {
  const int D = a.D, T = a.T;
  float* dl_s = smem;             // (D, R) dlogits
  float* dxf_s = dl_s + R * D;    // (D, R) grad of the fed-back probs
  float* xin_s = dxf_s + R * D;   // (D, R) layer-1 input
  float* h1_s = xin_s + R * D;    // (H, R) h1[t], layer-2 input
  float* hp1_s = h1_s + R * H;    // (H, R) h1[t-1]
  float* hp2_s = hp1_s + R * H;   // (H, R) h2[t-1]
  float* rh_s = hp2_s + R * H;    // (H, R)
  float* dx2_s = rh_s + R * H;    // (H, R) layer 2's dx
  float* da_s = dx2_s + R * H;    // (3H, R)
  const int row0 = blockIdx.x * R;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, n_warps = blockDim.x >> 5;

  for (int i = j; i < R * D; i += blockDim.x) dxf_s[i] = 0.0f;
  float dh1[R], dh2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh1[r] = dh2[r] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    load_tile<R>(t > 0 ? a.probs + (size_t)(t - 1) * B * D : a.start, xin_s, row0, B, D);
    // h_{t-1}: the stored h[t-1], or the initial state at t = 0 (unrounded
    // beside bf16 sequences). The two branches are spelled out here: moved
    // into a helper function, the same loads cost the float build 200
    // registers a thread instead of 168 (ptxas for sm_90a)
    if constexpr (std::is_same_v<TS, TV>) {
      load_tile<R>(t > 0 ? a.h1seq + (size_t)(t - 1) * B * H : a.h1_0, hp1_s, row0, B, H);
      if constexpr (NL == 2) {
        load_tile<R>(a.h1seq + (size_t)t * B * H, h1_s, row0, B, H);
        load_tile<R>(t > 0 ? a.h2seq + (size_t)(t - 1) * B * H : a.h2_0, hp2_s, row0, B, H);
      }
    } else {
      if (t > 0) load_tile<R>(a.h1seq + (size_t)(t - 1) * B * H, hp1_s, row0, B, H);
      else load_tile<R>(a.h1_0, hp1_s, row0, B, H);
      if constexpr (NL == 2) {
        load_tile<R>(a.h1seq + (size_t)t * B * H, h1_s, row0, B, H);
        if (t > 0) load_tile<R>(a.h2seq + (size_t)(t - 1) * B * H, hp2_s, row0, B, H);
        else load_tile<R>(a.h2_0, hp2_s, row0, B, H);
      }
    }
    // dlogits, one warp per row; dxf_s was written by the previous step's
    // layer-1 transpose, which ended with a barrier
    for (int r = warp; r < R; r += n_warps) {
      const int row = row0 + r;
      if (row >= B) {
        for (int d = lane; d < D; d += 32) dl_s[d * R + r] = 0.0f;
        continue;
      }
      const size_t base = ((size_t)t * B + row) * D;
      float s = 0.0f;
      if constexpr (OUT == kSoftmax) {
        for (int d = lane; d < D; d += 32) {
          s += (to_f32(a.g_probs[base + d]) + dxf_s[d * R + r]) * to_f32(a.probs[base + d]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      for (int d = lane; d < D; d += 32) {
        const float p = to_f32(a.probs[base + d]);
        const float gp = to_f32(a.g_probs[base + d]) + dxf_s[d * R + r];
        float dl;
        if constexpr (OUT == kSoftmax) {
          dl = p * (gp - s);
        } else if constexpr (OUT == kSigmoid) {
          dl = gp * p * (1.0f - p);
        } else {
          dl = gp;
        }
        dl += to_f32(a.g_logits[base + d]);
        dl_s[d * R + r] = dl;
        a.dlogits[base + d] = round_as<TG>(dl);
      }
    }
    __syncthreads();
    // dh of the top layer: dlogits @ Wo^T plus its carry
    float acc[R], v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float w = to_f32(a.wot[(size_t)d * H + j]);
      load_rows<R>(dl_s + d * R, v);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (NL == 2) {
        dh2[r] += acc[r];
      } else {
        dh1[r] += acc[r];
      }
    }
    if constexpr (NL == 2) {
      gru_cell_bwd<R, TV>(h1_s, H, hp2_s, dh2, da_s, rh_s, dx2_s, a.w2, a.u2,
                          a.b2, a.u2t, a.w2t, H);
      store_columns<R, TG>(da_s, a.da2 + (size_t)t * B * 3 * H, row0, B, 3 * H, 3, H);
      store_columns<R>(rh_s, a.rh2 + (size_t)t * B * H, row0, B, H, 1, H);
      load_rows<R>(dx2_s + j * R, v);
#pragma unroll
      for (int r = 0; r < R; ++r) dh1[r] += v[r];
      // the layer-1 transpose writes rh_s before its first barrier
      __syncthreads();
    }
    gru_cell_bwd<R, TV>(xin_s, D, hp1_s, dh1, da_s, rh_s, dxf_s, a.w1, a.u1,
                        a.b1, a.u1t, a.w1t, H);
    store_columns<R, TG>(da_s, a.da1 + (size_t)t * B * 3 * H, row0, B, 3 * H, 3, H);
    store_columns<R>(rh_s, a.rh1 + (size_t)t * B * H, row0, B, H, 1, H);
  }
  store_tile<R>(dxf_s, a.d_start, row0, B, D);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= B) break;
    a.d_h1_0[(size_t)row * H + j] = from_f32<TV>(dh1[r]);
    if constexpr (NL == 2) a.d_h2_0[(size_t)row * H + j] = from_f32<TV>(dh2[r]);
  }
}

template <int R, typename TV, typename TG, typename TS>
__device__ __forceinline__ void bwd_heads(const DecodeHeadsBwd<TV, TS>& heads,
                                          int B, int H, float* smem) {
  const DecodeHeadBwdT<TV, TS>& a = heads.h[blockIdx.y];
  const bool two = a.n_layers == 2;
  switch (a.out_act) {
    case kSoftmax:
      two ? decode_head_bwd<2, kSoftmax, R, TV, TG>(a, B, H, smem)
          : decode_head_bwd<1, kSoftmax, R, TV, TG>(a, B, H, smem);
      break;
    case kSigmoid:
      two ? decode_head_bwd<2, kSigmoid, R, TV, TG>(a, B, H, smem)
          : decode_head_bwd<1, kSigmoid, R, TV, TG>(a, B, H, smem);
      break;
    default:  // kLinear; the host checked the code
      two ? decode_head_bwd<2, kLinear, R, TV, TG>(a, B, H, smem)
          : decode_head_bwd<1, kLinear, R, TV, TG>(a, B, H, smem);
      break;
  }
}

template <typename TV>
__global__ void gru_decode_bwd_kernel(DecodeHeadsBwd<TV> heads, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  bwd_heads<kRows, TV, float>(heads, B, H, smem);
}

// the bf16-residual build: float heads reading h sequences stored in bf16
__global__ void gru_decode_bwd_resid_kernel(DecodeHeadsBwd<float, bf16> heads,
                                            int B, int H) {
  extern __shared__ __align__(16) float smem[];
  bwd_heads<kRows, float, float>(heads, B, H, smem);
}

template <typename TV>
__global__ void __launch_bounds__(kWideThreads)
    gru_decode_bwd_wide_kernel(DecodeHeadsBwd<TV> heads, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  bwd_heads<kWideRows, TV, TV>(heads, B, H, smem);
}

// rows 7 and 8 in bf16 on the 2-row layout: the streams left unrounded
__global__ void __launch_bounds__(kWideThreads)
    gru_decode_bwd_wide_row8_kernel(DecodeHeadsBwd<bf16> heads, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  bwd_heads<kWideRows, bf16, float>(heads, B, H, smem);
}

template <int R, typename TV, typename TS, typename Kernel>
int launch(Kernel kernel, const DecodeHeadBwdT<TV, TS>* heads, int n_heads,
           int B, int H, void* stream) {
  if (n_heads < 1 || n_heads > kMaxHeads || B < 1 || H < 32 || H % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeHeadsBwd<TV, TS> all{};
  size_t smem = 0;
  for (int k = 0; k < n_heads; ++k) {
    const DecodeHeadBwdT<TV, TS>& a = heads[k];
    if (a.T < 1 || a.D < 1 || (a.n_layers != 1 && a.n_layers != 2) ||
        (a.out_act != kSoftmax && a.out_act != kSigmoid && a.out_act != kLinear)) {
      return (int)cudaErrorInvalidValue;
    }
    all.h[k] = a;
    const size_t need = sizeof(float) * bwd_smem_floats(a.D, H, R);
    if (need > smem) smem = need;
  }
  cudaError_t err = fit_block(kernel, H, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + R - 1) / R, n_heads);
  kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(all, B, H);
  return (int)cudaGetLastError();
}

}  // namespace mvt

extern "C" int mvt_gru_decode_bwd(const mvt::DecodeHeadBwdT<float>* heads,
                                  int n_heads, int B, int H, void* stream) {
  using namespace mvt;
  return launch<kRows>(gru_decode_bwd_kernel<float>, heads, n_heads, B, H,
                       stream);
}

extern "C" int mvt_gru_decode_bwd_bf16(const mvt::DecodeHeadBwdT<mvt::bf16>* heads,
                                       int n_heads, int B, int H,
                                       void* stream) {
  using namespace mvt;
  return launch<kRows>(gru_decode_bwd_kernel<bf16>, heads, n_heads, B, H,
                       stream);
}

extern "C" int mvt_gru_decode_bwd_resid(
    const mvt::DecodeHeadBwdT<float, mvt::bf16>* heads, int n_heads, int B,
    int H, void* stream) {
  using namespace mvt;
  return launch<kRows>(gru_decode_bwd_resid_kernel, heads, n_heads, B, H,
                       stream);
}

extern "C" int mvt_gru_decode_bwd_wide(const mvt::DecodeHeadBwdT<float>* heads,
                                       int n_heads, int B, int H,
                                       void* stream) {
  using namespace mvt;
  return launch<kWideRows>(gru_decode_bwd_wide_kernel<float>, heads, n_heads,
                           B, H, stream);
}

extern "C" int mvt_gru_decode_bwd_wide_bf16(
    const mvt::DecodeHeadBwdT<mvt::bf16>* heads, int n_heads, int B, int H,
    void* stream) {
  using namespace mvt;
  return launch<kWideRows>(gru_decode_bwd_wide_kernel<bf16>, heads, n_heads,
                           B, H, stream);
}

extern "C" int mvt_gru_decode_bwd_wide_row8_bf16(
    const mvt::DecodeHeadBwdT<mvt::bf16>* heads, int n_heads, int B, int H,
    void* stream) {
  using namespace mvt;
  return launch<kWideRows>(gru_decode_bwd_wide_row8_kernel, heads, n_heads, B,
                           H, stream);
}

extern "C" const char* mvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
