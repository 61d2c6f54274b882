// Kernel B's chain (gru_decode.cu): the autoregressive decode of one 1- or
// 2-layer GRU head on thread-block clusters (lstm_cluster.cuh's helpers and
// the float products of gru_cell_fwd.cuh, kernel A's chain).
//
// Math (midi_vae_tpu/ops/fused_decoder.py::_gru_gates :48-59,
// _decode_kernel_2layer :61-92, _decode_kernel_1layer :95-123): at each
// step t the layer cells run on x (start at t = 0, then the previous step's
// probs),
//   z, r = sig(x W[:, :2H] + h U[:, :2H] + b[:2H])
//   hh   = act(x W[:, 2H:] + b[2H:] + (r h) U[:, 2H:])
//   h'   = z h + (1 - z) hh
// layer 2 on layer 1's h' of the same step; then logits = h_last Wo + bo,
// probs = act_out(logits) (softmax, sigmoid or linear over D), and probs is
// the next x. probs and logits leave time-major, (T, B, D). Everything is
// float32.
//
// Layout. One cluster of C CTAs (512 threads each, one an SM) owns `rows`
// batch rows for all T steps. CTA c owns the hidden units [c Hc, (c+1) Hc)
// of each layer, Hc = H / C: their gate columns of W1, U1, W2 and U2, and
// rows [c Hc, (c+1) Hc) of Wo. Each CTA holds the whole x, h1, h2 and r h
// of its rows in shared memory, feature-major (depth, rows rounded to 8), as
// A's chain does. A thread of split 0 (the owner) owns one unit's gates on 8
// rows; `splits` threads share each such tile's depth, their partials
// summed in split order (gru_reduce). A layer's step:
//   P1 (rows, 3 Hc) = x . W slice over x's depth (z, r and the candidate's
//      x W_h) + h . U_zr slice (z, r): z, r; x is the previous step's probs,
//      so x W cannot be a pre-pass: layer 1 takes it here as a third depth
//      segment of P1;
//   X1 r h of the CTA's units into every peer's r h tile (16-byte stores
//      through distributed shared memory); one cluster barrier;
//   P2 (rows, Hc) = (r h) . U_h slice: hh and h';
//   X2 h' into every peer's h tile; one cluster barrier.
// The readout: after layer 2's P2 (layer 1's in a 1-layer head) each CTA
// computes its partial logits (rows, D) over its own Hc units of h' and
// Wo's own rows, and pushes them, into its slot of every peer's partials,
// in the same X2 exchange as h'. After that barrier every CTA sums the C
// partials in cluster-rank order (the sum is the same in every CTA and from
// run to run), adds bo and runs the output activation over the row's D
// itself, so it holds the whole next x and no exchange feeds back; it stores
// its share of probs' and logits' columns. So a step takes four cluster
// barriers in a 2-layer head, two in a 1-layer head.
// Each barrier also frees the tile its peers write next (a peer pushes r h
// only after the barrier that ends every CTA's P2 of the layer before, h'
// only after the one that ends every P1, the partials only after layer 1's
// barriers of the next step), so one tile of each is enough; every store
// into a peer's shared memory comes before a barrier the peer waits at, so a
// CTA leaves after its last step with no closing barrier.
//
// The weights' slices stream from L2 at every step through one ring of
// `stages` chunks of `chunk` depth rows that runs on across the phases,
// layers and steps (a chunk holds 3 Hc, 2 Hc or Hc columns: P1's x
// segment, its h segment, P2). The wrapper packs each CTA's slices so that
// a chunk is one contiguous block (layer 1's x depth zero-padded to a whole
// chunk), and one thread asks the Tensor Memory Accelerator for the whole
// block (cp.async.bulk, completion counted on the slot's mbarrier): a ring
// of 16-byte cp.async copies a thread spent about half of the chain's time
// waiting (PERF.md, Findings).
// Products are FFMA (gru_product), as in A's float chain.
//
// What bounds it: the serial chain, T steps of two dependent products a
// layer and their cluster barriers, and the slices' reads from L2 at every
// step (every cluster reads every weight once a step);
// ops/_layout.py::gru_decode_plan picks C, the rows a cluster takes, the
// splits and the ring's stages. Every kernel launches on the caller's stream
// and allocates nothing.
//
// Kernel D (gru_decode_train.cu: every build, D, D bf16, D resid and the
// wide ones) runs this chain for training (tanh cells), one head a launch,
// with each layer's h sequence stored (T, B, H) as kernel E reads it back:
// each CTA stores its own Hc units of every row, 4 units a store, while the
// X2 exchange's barrier completes. In bf16 the operands, outputs and slices
// are bf16 (the slices widened as the products read them) and the step
// rounds what the Pallas kernel stores (gru_decode_body.cuh): the fed-back
// probs, the carries after the readout has read them (layer 2 and the
// readout take layer 1's and the top layer's float h of the step), the h
// sequences, probs and logits. D resid's instance is the float one with the
// h sequences stored in bf16 (the store type TS). Two designs: B's FFMA
// body with the stores (gru_decode_chain_kernel<..., TV, true, TS>) and the
// tensor-core one (gru_decode_chain_tc_kernel, below), each at the plan of
// ops/_layout.py::dec_train_plan. B's serving instance (<float, false>)
// stores nothing and is unchanged.
#pragma once

#include "gru_cell_fwd.cuh"

namespace mvt {

// A streamed chunk holds 32, 64 or 128 depth rows of a slice, the plan's
// (a chunk's wait and barrier cost about the same whatever its depth, so
// it takes the largest that fits: PERF.md, Findings).
// the most threads that share a tile's depth (a power of two dividing a chunk)
constexpr int kDecMaxSplits = 16;
// the most chunks in the ring
constexpr int kDecMaxStages = 8;
// the dynamic shared memory a chain CTA may take: a block's 227 KB less
// 1 KB for the static (the ring's mbarriers)
constexpr size_t kDecSmem = 232448 - 1024;

template <typename TV = float, typename TS = TV>
struct GruDecodeChainArgsT {
  const TV* start;  // (B, D)
  const TV* h1_0;   // (B, H)
  const TV* h2_0;   // (B, H), or null (1 layer)
  // the weights' slices packed per CTA (ops/gru_decode.py::pack_slices), of
  // the operands' type TV: for each layer l, its x segment (C, depth_l, 3 Hc: W's z, r
  // and candidate columns of the CTA's units, layer 1's depth D zero-padded
  // to whole chunks), its h segment (C, H, 2 Hc: U's z and r columns) and
  // P2's (C, H, Hc: U's candidate columns); a chunk of a segment is then one
  // contiguous block; the second layer's three are null in a 1-layer head
  const TV* slices[6];
  const TV* b1;     // (3H,)
  const TV* b2;     // (3H,), or null
  const TV* wo;     // (H, D)
  const TV* bo;     // (D,)
  TV* probs;        // (T, B, D)
  TV* logits;       // (T, B, D)
  int T, B, D, H;
  int rows;    // batch rows a cluster
  int splits;  // threads sharing a tile's depth
  int stages;  // chunks in the ring
  int chunk;   // depth rows of a chunk
  // D's training instance: each layer's h sequence (T, B, H), of the store
  // type TS (TV, or bf16 beside float operands in D resid's instance); B's:
  // null
  TS* hseq[2];
  int out_act;  // the tensor-core instance's output activation (B's: a template argument)
};
using GruDecodeChainArgs = GruDecodeChainArgsT<float>;

// four neighbouring values of an h sequence's row in one store (float: 16
// bytes; bf16: 8, each rounded to nearest even)
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// layer 1's x depth, padded to whole chunks; D padded to 16 bytes
__host__ __device__ constexpr int dec_dp(int D, int chunk) {
  return (D + chunk - 1) / chunk * chunk;
}
__host__ __device__ constexpr int dec_dq(int D) { return (D + 3) / 4 * 4; }

// Shared memory of a decode chain CTA, in bytes: the ring (of the slices'
// `elem`-byte values) | x (Dp, R8) | logits (Dq, R8) | h1 (, h2) and r h (H,
// R8) | every CTA's partial logits (C, R8, Dq) | Wo's own rows (Hc, Dq) |
// the splits' partials (S - 1, ntiles, kTileStride), float. ops/_layout.py's
// gru_decode_smem computes the same.
__host__ __device__ constexpr size_t gru_decode_chain_smem(int NL, int D, int H, int C, int rows,
                                                           int splits, int stages, int chunk,
                                                           int elem = 4) {
  const size_t Hc = H / C, R8 = round8(rows), Dq = dec_dq(D);
  return (size_t)elem * stages * chunk * 3 * Hc +
         4 * ((size_t)dec_dp(D, chunk) * R8 + Dq * R8 + (size_t)(NL + 1) * H * R8 +
              (size_t)C * R8 * Dq + Hc * Dq + (size_t)(splits - 1) * Hc * (R8 / 8) * kTileStride);
}

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1). TV and
// TRAIN select D's training instance (gru_decode_train.cu): the operands and
// outputs of type TV, each layer's h sequence stored as TS; B's serving
// instance is <float, false>. D resid's instance is <float, true, bf16>:
// every value and rounding of D's float instance, only the stored h
// sequences rounded to bf16, so its probs and logits are D's bit for bit at
// the same plan.
template <int NL, int ACT, int OUT, typename TV = float, bool TRAIN = false, typename TS = TV>
__global__ void __launch_bounds__(kChainThreads, 1) gru_decode_chain_kernel(
    const GruDecodeChainArgsT<TV, TS> a) {
  extern __shared__ __align__(16) unsigned char dec_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, D = a.D, T = a.T, rows = a.rows, S = a.splits;
  const int Hc = H / C, R8 = round8(rows), ntiles = Hc * (R8 / 8);
  const int K = a.chunk, Dp = dec_dp(D, K), Dq = dec_dq(D);
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // thread tid works on tile tid % ntiles (unit ul, rows 8 ro ..) in split
  // tid / ntiles; split 0 owns the tile's pairs
  const int tile = tid % ntiles, split = tid / ntiles;
  const int ul = tile % Hc, ro = tile / Hc, unit = c * Hc + ul;
  const bool owner = split == 0;
  // the ring holds the slices' values (TV), the tiles after it float
  TV* ring = reinterpret_cast<TV*>(dec_smem_raw);
  float* xs = reinterpret_cast<float*>(ring + (size_t)a.stages * K * 3 * Hc);
  float* ls = xs + (size_t)Dp * R8;
  float* hs[2];
  hs[0] = ls + (size_t)Dq * R8;
  hs[1] = hs[0] + (size_t)H * R8;
  float* rhs = hs[0] + (size_t)NL * H * R8;
  float* ps = rhs + (size_t)H * R8;
  float* wos = ps + (size_t)C * R8 * Dq;
  float* part = wos + (size_t)Hc * Dq;

  // the chunks of a step: per layer P1's x segment (layer 1: nx, layer 2:
  // nh), its h segment (nh), P2 (nh)
  const int nx = Dp / K, nh = H / K;
  const int per_step = nx + (3 * NL - 1) * nh, total_chunks = T * per_step;
  const size_t slot_elems = (size_t)K * 3 * Hc;
  __shared__ unsigned long long bars[kDecMaxStages];  // a slot's transfers
  // chunk j of the sequence (thread 0 alone): segment seg of its step
  // (layer seg / 3; P1's x, P1's h or P2's), its ch-th block of
  // K x width floats, into slot j % stages
  auto copy_chunk = [&](int j) {
    const int js = j % per_step;
    int seg = 0, ch = js;
    if (js >= nx) {
      seg = 1 + (js - nx) / nh;
      ch = (js - nx) % nh;
    }
    const int width = (3 - seg % 3) * Hc, depth = seg == 0 ? Dp : H;
    const TV* src = a.slices[seg] + ((size_t)c * depth + (size_t)ch * K) * width;
    const unsigned bytes = K * width * sizeof(TV);
    unsigned long long* bar = &bars[j % a.stages];
    // the slot's last reads (generic proxy) come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);
    bulk_copy(ring + (size_t)(j % a.stages) * slot_elems, src, bytes, bar);
  };
  if (tid == 0) {
    for (int j = 0; j < a.stages; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < a.stages - 1 && j < total_chunks; ++j) copy_chunk(j);
  }
  {  // every tile starts at zero (the padding rows and depths stay so)
    float4* p = reinterpret_cast<float4*>(xs);
    const size_t n4 = ((size_t)Dp * R8 + (size_t)Dq * R8 + (size_t)(NL + 1) * H * R8 +
                       (size_t)C * R8 * Dq + (size_t)Hc * Dq) / 4;
    for (size_t i = tid; i < n4; i += blockDim.x) p[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    if (row0 + r < B) xs[(size_t)d * R8 + r] = to_f32(a.start[(size_t)(row0 + r) * D + d]);
  }
  for (int l = 0; l < NL; ++l) {
    const TV* h0 = l ? a.h2_0 : a.h1_0;
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H, k = i % H;
      if (row0 + r < B) hs[l][(size_t)k * R8 + r] = to_f32(h0[(size_t)(row0 + r) * H + k]);
    }
  }
  for (int i = tid; i < Hc * D; i += blockDim.x) {
    const int k = i / D, d = i % D;
    wos[(size_t)k * Dq + d] = to_f32(a.wo[(size_t)(c * Hc + k) * D + d]);
  }
  float bias[2][3] = {};
  if (owner) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
#pragma unroll
      for (int q = 0; q < 3; ++q) bias[l][q] = to_f32((l ? a.b2 : a.b1)[q * H + unit]);
    }
  }
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  // one segment's product: acc (not zeroed here) += the tile (depth rows)
  // . the NQ columns col of the segment's n chunks (row stride ld), over the
  // thread's split of each chunk's depth
  int chunk_seq = 0;  // chunks consumed so far (over all steps)
  auto segment = [&](const float* src_tile, const auto& col, int ld, int n, auto& acc) {
    constexpr int NQ = std::extent_v<std::remove_reference_t<decltype(col)>>;
    const int per = K / S;
    for (int ch = 0; ch < n; ++ch) {
      // every thread is done with the ring slot the next copy refills;
      // then chunk chunk_seq has landed
      __syncthreads();
      const int next = chunk_seq + a.stages - 1;
      if (tid == 0 && next < total_chunks) copy_chunk(next);
      mbar_wait(&bars[chunk_seq % a.stages], (chunk_seq / a.stages) & 1);
      if (split < S) {
        const int k0 = ch * K + split * per;
        gru_product<NQ>(src_tile, R8, ro, ring + (size_t)(chunk_seq % a.stages) * slot_elems,
                        ld, col, k0, k0 + per, ch * K, acc);
      }
      ++chunk_seq;
    }
  };
  const size_t own = (size_t)c * Hc * R8;  // the CTA's columns of an h or r h tile, in floats
  const int cols3[3] = {ul, Hc + ul, 2 * Hc + ul};
  const int cols2[2] = {ul, Hc + ul};
  const int cols1[1] = {ul};
  // the CTA's share of the output columns
  const int dper = (D + C - 1) / C, d_lo = c * dper, d_hi = min(D, d_lo + dper);

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float* h = hs[l];
      const float* xin = l ? hs[0] : xs;
      // P1: x's segment, then h's into z's and r's own accumulators
      float acc[3][8] = {}, acc_zr[2][8] = {};
      segment(xin, cols3, 3 * Hc, l ? nh : nx, acc);
      segment(h, cols2, 2 * Hc, nh, acc_zr);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[q][r] += acc_zr[q][r];
      }
      gru_reduce(acc, part, S, ntiles, tile, split);
      // z and the candidate's x part stay in the owner's registers; h's own
      // columns stay in the tile until P2's epilogue overwrites them
      float zv[8] = {}, cand[8] = {};
      if (owner) {
        const float* hr = h + (size_t)unit * R8 + 8 * ro;
        float* rr = rhs + (size_t)unit * R8 + 8 * ro;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          zv[r] = activate<kSigmoid>(acc[0][r] + bias[l][0]);
          rr[r] = activate<kSigmoid>(acc[1][r] + bias[l][1]) * hr[r];
          cand[r] = acc[2][r] + bias[l][2];
        }
      }
      __syncthreads();  // the CTA's columns of r h are in its tile
      // X1
      push_columns(cluster, reinterpret_cast<char*>(rhs), Hc * R8 / 4,
                   [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
      cluster_arrive();
      cluster_wait();
      // P2
      float acc_h[1][8] = {};
      segment(rhs, cols1, Hc, nh, acc_h);
      gru_reduce(acc_h, part, S, ntiles, tile, split);
      if (owner) {
        float* hr = h + (size_t)unit * R8 + 8 * ro;
        float hv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float hh = activate<ACT>(acc_h[0][r] + cand[r]);
          hv[r] = 8 * ro + r < rows ? zv[r] * hr[r] + (1.0f - zv[r]) * hh : 0.0f;
        }
        *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<float4*>(hr + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
      }
      __syncthreads();  // the CTA's columns of h' are in its tile
      if (l == NL - 1) {
        // the readout's partial logits over the CTA's units, into its slot
        float* slot = ps + (size_t)c * R8 * Dq;
        const float* hc = h + own;
        for (int i = tid; i < rows * D; i += blockDim.x) {
          const int r = i / D, d = i % D;
          float s = 0.0f;
          for (int k = 0; k < Hc; ++k) s = fmaf(hc[(size_t)k * R8 + r], wos[(size_t)k * Dq + d], s);
          slot[(size_t)r * Dq + d] = s;
        }
        __syncthreads();
        push_columns(cluster, reinterpret_cast<char*>(ps), R8 * Dq / 4,
                     [&](int j) { return ((size_t)c * R8 * Dq + 4 * j) * 4; }, C, c);
      }
      // X2
      push_columns(cluster, reinterpret_cast<char*>(h), Hc * R8 / 4,
                   [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
      cluster_arrive();
      if constexpr (TRAIN) {
        // the layer's h sequence: the CTA's own units of each row, 4 units
        // (16 bytes of float, 8 of bf16) a store, while the barrier completes
        // (no peer writes these columns)
        const int per_row = Hc / 4;
        TS* dst = a.hseq[l] + (size_t)t * B * H + c * Hc;
        for (int i = tid; i < rows * per_row; i += blockDim.x) {
          const int r = i / per_row, g = 4 * (i % per_row);
          if (row0 + r >= B) continue;
          const float* src = h + (size_t)(c * Hc + g) * R8 + r;
          store4(dst + (size_t)(row0 + r) * H + g, src[0], src[R8], src[2 * R8], src[3 * R8]);
        }
      }
      cluster_wait();
    }
    // the readout: the partials summed in rank order, bo, the activation
    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float s = to_f32(a.bo[d]);
      for (int cc = 0; cc < C; ++cc) s += ps[((size_t)cc * R8 + r) * Dq + d];
      ls[(size_t)d * R8 + r] = s;
    }
    __syncthreads();
    if constexpr (OUT == kSoftmax) {
      for (int r = warp; r < rows; r += kChainWarps) {
        float m = __int_as_float(0xff800000);  // -inf
        for (int d = lane; d < D; d += 32) m = fmaxf(m, ls[(size_t)d * R8 + r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float s = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float e = expf(ls[(size_t)d * R8 + r] - m);
          xs[(size_t)d * R8 + r] = e;
          s += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        // the fed-back probs as the Pallas scratch holds them (bf16: rounded)
        for (int d = lane; d < D; d += 32) {
          xs[(size_t)d * R8 + r] = round_as<TV>(xs[(size_t)d * R8 + r] / s);
        }
      }
    } else {
      for (int i = tid; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        xs[(size_t)d * R8 + r] = round_as<TV>(activate<OUT>(ls[(size_t)d * R8 + r]));
      }
    }
    if constexpr (!std::is_same_v<TV, float>) {
      // the carries as the Pallas scratch holds them, rounded after layer 2
      // and the readout have read them float: every CTA rounds its own copy
      // of the whole tiles (no peer writes them before the next step's
      // barriers)
      for (size_t i = tid; i < (size_t)NL * H * R8; i += blockDim.x) {
        hs[0][i] = round_as<TV>(hs[0][i]);
      }
    }
    __syncthreads();
    // the CTA's columns of the step's probs and logits
    const int dn = d_hi - d_lo;
    for (int i = tid; i < rows * dn; i += blockDim.x) {
      const int r = i / dn, d = d_lo + i % dn;
      if (row0 + r >= B) continue;
      const size_t o = ((size_t)t * B + row0 + r) * D + d;
      a.probs[o] = from_f32<TV>(xs[(size_t)d * R8 + r]);
      a.logits[o] = from_f32<TV>(ls[(size_t)d * R8 + r]);
    }
  }
}

// ---------------------------------------------------------------------------
// D wide's tensor-core instance: the training decode with its products on
// the tensor cores
// ---------------------------------------------------------------------------

// The tensor-core instance runs CTAs of kDecTcThreads: its products are
// warp-wide mma.sync, and at 512 threads a CTA (128 registers a thread) its
// accumulators, the owners' gates and the chain's state spilled; a warp owns
// at most kDecTcMaxItems (m-tile, n-tile) items of a segment.
constexpr int kDecTcThreads = 256;
constexpr int kDecTcWarps = kDecTcThreads / 32;
constexpr int kDecTcMaxItems = 6;

// the depth splits of a segment of `width` columns over rows in m-tiles
__host__ __device__ constexpr int dec_tc_splits(int rows, int width, int chunk) {
  return gru_tc_splits((rows + 15) / 16 * width / 8, chunk / 8, kDecTcWarps);
}

// floats of the tensor-core instance's gate sums: P1's x segment's and h
// segment's side by side, P2's in the x segment's place
__host__ __device__ constexpr size_t dec_tc_gates(int H, int C, int rows, int chunk) {
  const int Hc = H / C, m16 = 16 * ((rows + 15) / 16);
  const size_t gx = (size_t)dec_tc_splits(rows, 3 * Hc, chunk) * m16 * (3 * Hc + 8);
  const size_t gh = (size_t)dec_tc_splits(rows, 2 * Hc, chunk) * m16 * (2 * Hc + 8);
  const size_t g2 = (size_t)dec_tc_splits(rows, Hc, chunk) * m16 * (Hc + 8);
  return gx + gh > g2 ? gx + gh : g2;
}

// Shared memory of the tensor-core instance, in bytes: B's chain's (the
// ring of `elem`-byte values, the x, logits, h and r h tiles, the partial
// logits, Wo's rows) with the gate sums in place of the splits' partials.
// ops/_layout.py's dec_tc_smem computes the same.
__host__ __device__ constexpr size_t dec_tc_smem(int NL, int D, int H, int C, int rows, int stages,
                                                 int chunk, int elem) {
  return gru_decode_chain_smem(NL, D, H, C, rows, 1, stages, chunk, elem) +
         4 * dec_tc_gates(H, C, rows, chunk);
}

// Grid: clusters * C CTAs of kDecTcThreads, cluster dims (C, 1, 1).
//
// D wide's training instance of B's chain (tanh cells, the h sequences
// stored, a bf16 head's roundings) with every product of a layer's step on
// mma.sync m16n8k8 (tc_segment of gru_cell_fwd.cuh): P1's x segment (3 Hc
// columns), its h segment (z and r) and P2, each into gate tiles of shared
// memory that the owners (one thread a unit and 8 rows, as in B's chain)
// sum in split order, the x segment's and the h segment's apart and then
// added, as B's FFMA accumulators are. The slices stream through B's ring
// in B-fragment order (ops/gru_decode.py::pack_tc_slices). Float32: three
// TF32 products a k-step (both operands split). bf16: the weights and the
// bf16 values of the tiles (the fed-back probs, the carried h) are exact in
// TF32, so layer 1's x segment and every h segment take one product; layer
// 2's x segment (layer 1's float h of the step) and P2 (float r h) two, the
// float operand split: the products of the Pallas kernel's bf16 operands
// exactly, summed in float. The readout's partial logits stay FFMA over
// the CTA's own units (Hc x D a row), as in B's chain.
template <int NL, typename TV>
__global__ void __launch_bounds__(kDecTcThreads, 1) gru_decode_chain_tc_kernel(
    const GruDecodeChainArgsT<TV> a) {
  extern __shared__ __align__(16) unsigned char dec_smem_raw[];
  __shared__ unsigned long long bars[kDecMaxStages];  // a slot's transfers
  constexpr bool kBf16 = std::is_same_v<TV, bf16>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int H = a.H, B = a.B, D = a.D, T = a.T, rows = a.rows;
  const int Hc = H / C, R8 = round8(rows), ntiles = Hc * (R8 / 8), mts = (rows + 15) / 16;
  const int K = a.chunk, ksteps = K / 8, Dp = dec_dp(D, K), Dq = dec_dq(D);
  const int row0 = (blockIdx.x / C) * rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // owners: thread tid < ntiles owns unit ul of rows 8 ro ..
  const bool owner = tid < ntiles;
  const int ul = tid % Hc, ro = tid / Hc, unit = c * Hc + ul;
  const int sx = dec_tc_splits(rows, 3 * Hc, K), sh = dec_tc_splits(rows, 2 * Hc, K);
  const int s2 = dec_tc_splits(rows, Hc, K);
  TV* ring = reinterpret_cast<TV*>(dec_smem_raw);
  float* xs = reinterpret_cast<float*>(ring + (size_t)a.stages * K * 3 * Hc);
  float* ls = xs + (size_t)Dp * R8;
  float* hs[2];
  hs[0] = ls + (size_t)Dq * R8;
  hs[1] = hs[0] + (size_t)H * R8;
  float* rhs = hs[0] + (size_t)NL * H * R8;
  float* ps = rhs + (size_t)H * R8;
  float* wos = ps + (size_t)C * R8 * Dq;
  float* gx = wos + (size_t)Hc * Dq;
  float* gh = gx + (size_t)sx * 16 * mts * (3 * Hc + 8);
  float* g2 = gx;  // P2's gate sums in the x segment's place

  // the chunks of a step: per layer P1's x segment (layer 1: nx, layer 2:
  // nh), its h segment (nh), P2 (nh)
  const int nx = Dp / K, nh = H / K;
  const int per_step = nx + (3 * NL - 1) * nh, total_chunks = T * per_step;
  const size_t slot_elems = (size_t)K * 3 * Hc;
  auto copy_chunk = [&](int j) {
    const int js = j % per_step;
    int seg = 0, ch = js;
    if (js >= nx) {
      seg = 1 + (js - nx) / nh;
      ch = (js - nx) % nh;
    }
    const int width = (3 - seg % 3) * Hc, depth = seg == 0 ? Dp : H;
    const TV* src = a.slices[seg] + ((size_t)c * depth + (size_t)ch * K) * width;
    const unsigned bytes = K * width * sizeof(TV);
    unsigned long long* bar = &bars[j % a.stages];
    // the slot's last reads (generic proxy) come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);
    bulk_copy(ring + (size_t)(j % a.stages) * slot_elems, src, bytes, bar);
  };
  if (tid == 0) {
    for (int j = 0; j < a.stages; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < a.stages - 1 && j < total_chunks; ++j) copy_chunk(j);
  }
  {  // every tile starts at zero (the padding rows and depths stay so)
    float4* p = reinterpret_cast<float4*>(xs);
    const size_t n4 = ((size_t)Dp * R8 + (size_t)Dq * R8 + (size_t)(NL + 1) * H * R8 +
                       (size_t)C * R8 * Dq + (size_t)Hc * Dq) / 4;
    for (size_t i = tid; i < n4; i += blockDim.x) p[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    if (row0 + r < B) xs[(size_t)d * R8 + r] = to_f32(a.start[(size_t)(row0 + r) * D + d]);
  }
  for (int l = 0; l < NL; ++l) {
    const TV* h0 = l ? a.h2_0 : a.h1_0;
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H, k = i % H;
      if (row0 + r < B) hs[l][(size_t)k * R8 + r] = to_f32(h0[(size_t)(row0 + r) * H + k]);
    }
  }
  for (int i = tid; i < Hc * D; i += blockDim.x) {
    const int k = i / D, d = i % D;
    wos[(size_t)k * Dq + d] = to_f32(a.wo[(size_t)(c * Hc + k) * D + d]);
  }
  float bias[2][3] = {};
  if (owner) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
#pragma unroll
      for (int q = 0; q < 3; ++q) bias[l][q] = to_f32((l ? a.b2 : a.b1)[q * H + unit]);
    }
  }
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  int seq = 0;  // chunks consumed so far (over all steps)
  const size_t own = (size_t)c * Hc * R8;  // the CTA's columns of an h or r h tile, in floats
  // the CTA's share of the output columns
  const int dper = (D + C - 1) / C, d_lo = c * dper, d_hi = min(D, d_lo + dper);
  auto segment = [&](auto products, const float* tile, int width, int splits, int n, float* g) {
    tc_segment<decltype(products)::value, kDecTcMaxItems, kDecTcWarps>(
        tile, R8, mts, width, mts * width / 8, splits, ksteps, ring, slot_elems, a.stages, n,
        total_chunks, seq, bars, copy_chunk, g);
  };
  using One = std::integral_constant<int, kBf16 ? 1 : 3>;
  using Two = std::integral_constant<int, kBf16 ? 2 : 3>;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float* h = hs[l];
      // P1: the x segment (layer 1: the fed-back probs, exact in bf16;
      // layer 2: layer 1's float h), then the h segment (the carry)
      if (l == 0) {
        segment(One{}, xs, 3 * Hc, sx, nx, gx);
      } else {
        segment(Two{}, hs[0], 3 * Hc, sx, nh, gx);
      }
      segment(One{}, h, 2 * Hc, sh, nh, gh);
      // z and the candidate's x part stay in the owner's registers; h's own
      // columns stay in the tile until P2's epilogue overwrites them
      float zv[8] = {}, cand[8] = {};
      if (owner) {
        const float* hr = h + (size_t)unit * R8 + 8 * ro;
        float* rr = rhs + (size_t)unit * R8 + 8 * ro;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int row = 8 * ro + r;
          const float az =
              tc_gate(gx, mts, 3 * Hc, sx, row, ul) + tc_gate(gh, mts, 2 * Hc, sh, row, ul);
          const float ar = tc_gate(gx, mts, 3 * Hc, sx, row, Hc + ul) +
                           tc_gate(gh, mts, 2 * Hc, sh, row, Hc + ul);
          zv[r] = activate<kSigmoid>(az + bias[l][0]);
          rr[r] = activate<kSigmoid>(ar + bias[l][1]) * hr[r];
          cand[r] = tc_gate(gx, mts, 3 * Hc, sx, row, 2 * Hc + ul) + bias[l][2];
        }
      }
      __syncthreads();  // the CTA's columns of r h are in its tile
      // X1
      push_columns(cluster, reinterpret_cast<char*>(rhs), Hc * R8 / 4,
                   [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
      cluster_arrive();
      cluster_wait();
      // P2 over the float r h
      segment(Two{}, rhs, Hc, s2, nh, g2);
      if (owner) {
        float* hr = h + (size_t)unit * R8 + 8 * ro;
        float hv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float hh = activate<kTanh>(tc_gate(g2, mts, Hc, s2, 8 * ro + r, ul) + cand[r]);
          hv[r] = 8 * ro + r < rows ? zv[r] * hr[r] + (1.0f - zv[r]) * hh : 0.0f;
        }
        *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<float4*>(hr + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
      }
      __syncthreads();  // the CTA's columns of h' are in its tile
      if (l == NL - 1) {
        // the readout's partial logits over the CTA's units, into its slot
        float* slot = ps + (size_t)c * R8 * Dq;
        const float* hc = h + own;
        for (int i = tid; i < rows * D; i += blockDim.x) {
          const int r = i / D, d = i % D;
          float s = 0.0f;
          for (int k = 0; k < Hc; ++k) s = fmaf(hc[(size_t)k * R8 + r], wos[(size_t)k * Dq + d], s);
          slot[(size_t)r * Dq + d] = s;
        }
        __syncthreads();
        push_columns(cluster, reinterpret_cast<char*>(ps), R8 * Dq / 4,
                     [&](int j) { return ((size_t)c * R8 * Dq + 4 * j) * 4; }, C, c);
      }
      // X2
      push_columns(cluster, reinterpret_cast<char*>(h), Hc * R8 / 4,
                   [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
      cluster_arrive();
      {  // the layer's h sequence: the CTA's own units of each row, 4 units
         // a store, while the barrier completes (no peer writes them)
        const int per_row = Hc / 4;
        TV* dst = a.hseq[l] + (size_t)t * B * H + c * Hc;
        for (int i = tid; i < rows * per_row; i += blockDim.x) {
          const int r = i / per_row, g = 4 * (i % per_row);
          if (row0 + r >= B) continue;
          const float* src = h + (size_t)(c * Hc + g) * R8 + r;
          store4(dst + (size_t)(row0 + r) * H + g, src[0], src[R8], src[2 * R8], src[3 * R8]);
        }
      }
      cluster_wait();
    }
    // the readout: the partials summed in rank order, bo, the activation
    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float s = to_f32(a.bo[d]);
      for (int cc = 0; cc < C; ++cc) s += ps[((size_t)cc * R8 + r) * Dq + d];
      ls[(size_t)d * R8 + r] = s;
    }
    __syncthreads();
    if (a.out_act == kSoftmax) {
      for (int r = warp; r < rows; r += kDecTcWarps) {
        float m = __int_as_float(0xff800000);  // -inf
        for (int d = lane; d < D; d += 32) m = fmaxf(m, ls[(size_t)d * R8 + r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float s = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float e = expf(ls[(size_t)d * R8 + r] - m);
          xs[(size_t)d * R8 + r] = e;
          s += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        // the fed-back probs as the Pallas scratch holds them (bf16: rounded)
        for (int d = lane; d < D; d += 32) {
          xs[(size_t)d * R8 + r] = round_as<TV>(xs[(size_t)d * R8 + r] / s);
        }
      }
    } else {
      const bool sig = a.out_act == kSigmoid;  // else linear
      for (int i = tid; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        const float v = ls[(size_t)d * R8 + r];
        xs[(size_t)d * R8 + r] = round_as<TV>(sig ? activate<kSigmoid>(v) : v);
      }
    }
    if constexpr (kBf16) {
      // the carries as the Pallas scratch holds them, rounded after layer 2
      // and the readout have read them float: every CTA rounds its own copy
      // of the whole tiles (no peer writes them before the next step's
      // barriers)
      for (size_t i = tid; i < (size_t)NL * H * R8; i += blockDim.x) {
        hs[0][i] = round_as<TV>(hs[0][i]);
      }
    }
    __syncthreads();
    // the CTA's columns of the step's probs and logits
    const int dn = d_hi - d_lo;
    for (int i = tid; i < rows * dn; i += blockDim.x) {
      const int r = i / dn, d = d_lo + i % dn;
      if (row0 + r >= B) continue;
      const size_t o = ((size_t)t * B + row0 + r) * D + d;
      a.probs[o] = from_f32<TV>(xs[(size_t)d * R8 + r]);
      a.logits[o] = from_f32<TV>(ls[(size_t)d * R8 + r]);
    }
  }
}

// D wide's tensor-core instance at its plan (ops/_layout.py::dec_tc_plan:
// cluster size, rows a cluster, stages, chunk; the slices packed in
// B-fragment order; the output activation a.out_act); cudaErrorInvalidValue
// for a plan it does not run.
template <int NL, typename TV>
int launch_gru_decode_chain_tc(const GruDecodeChainArgsT<TV>& a, int cluster, void* stream) {
  const int H = a.H;
  if (a.out_act != kSoftmax && a.out_act != kSigmoid && a.out_act != kLinear) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.T < 1 || a.B < 1 || a.D < 1 || cluster < 1 || cluster > kMaxCluster || H < 32 ||
      (a.chunk != 32 && a.chunk != 64 && a.chunk != 128) || H % a.chunk != 0 ||
      H % cluster != 0 || (H / cluster) % 8 != 0 || a.rows < 1 || a.stages < 2 ||
      a.stages > kDecMaxStages || a.hseq[0] == nullptr || (NL == 2 && a.hseq[1] == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 3 * NL; ++i) {
    if (a.slices[i] == nullptr || (reinterpret_cast<size_t>(a.slices[i]) & 15) != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int Hc = H / cluster, mts = (a.rows + 15) / 16;
  if (Hc * (round8(a.rows) / 8) > kDecTcThreads ||
      (mts * 3 * Hc / 8 + kDecTcWarps - 1) / kDecTcWarps > kDecTcMaxItems) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = dec_tc_smem(NL, a.D, H, cluster, a.rows, a.stages, a.chunk, sizeof(TV));
  if (smem > kDecSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gru_decode_chain_tc_kernel<NL, TV>;
  static size_t configured = 0;  // the attributes once, again for more shared memory
  if (smem > configured) {
    cudaError_t err = cluster_config(kernel, kMaxCluster, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  ClusterLaunch l((a.B + a.rows - 1) / a.rows * cluster, cluster, smem, stream, kDecTcThreads);
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The chain of one head at the plan of ops/_layout.py::gru_decode_plan
// (cluster size, rows a cluster, splits, stages); cudaErrorInvalidValue for
// a plan the build does not run.
template <int NL, int ACT, int OUT, typename TV = float, bool TRAIN = false, typename TS = TV>
int launch_gru_decode_chain(const GruDecodeChainArgsT<TV, TS>& a, int cluster, void* stream) {
  const int H = a.H, S = a.splits;
  if (a.T < 1 || a.B < 1 || a.D < 1 || cluster < 1 || cluster > kMaxCluster || H < 32 ||
      (a.chunk != 32 && a.chunk != 64 && a.chunk != 128) || H % a.chunk != 0 ||
      H % cluster != 0 || (H / cluster) % 4 != 0 || a.rows < 1 || S < 1 ||
      (S & (S - 1)) != 0 || S > kDecMaxSplits || a.stages < 2 || a.stages > kDecMaxStages) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 3 * NL; ++i) {
    if (a.slices[i] == nullptr || (reinterpret_cast<size_t>(a.slices[i]) & 15) != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (TRAIN && (a.hseq[0] == nullptr || (NL == 2 && a.hseq[1] == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = H / cluster * (round8(a.rows) / 8);
  if (tiles * S > kChainThreads) return (int)cudaErrorInvalidValue;
  // the ring's mbarriers take static shared memory beside the dynamic
  const size_t smem =
      gru_decode_chain_smem(NL, a.D, H, cluster, a.rows, S, a.stages, a.chunk, sizeof(TV));
  if (smem > kDecSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gru_decode_chain_kernel<NL, ACT, OUT, TV, TRAIN, TS>;
  static size_t configured = 0;  // the attributes once, again for more shared memory
  if (smem > configured) {
    cudaError_t err = cluster_config(kernel, kMaxCluster, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  ClusterLaunch l((a.B + a.rows - 1) / a.rows * cluster, cluster, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace mvt
