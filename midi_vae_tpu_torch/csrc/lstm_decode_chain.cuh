// Kernel M's chain (lstm_decode.cu): the autoregressive decode of one 1- or
// 2-layer LSTM serving head on thread-block clusters. Kernel B's decode
// chain (gru_decode_chain.cuh: its TMA ring, FFMA products, split partials
// and readout) with the LSTM cell of the forward chain (lstm_cell_fwd.cuh).
//
// Math (midi_vae_tpu/ops/fused_lstm.py::_decode_kernel_2layer :478,
// _decode_kernel_1layer :511, the cell _lstm_gates :54): at each step t the
// layer cells run on x (start at t = 0, then the previous step's probs),
//   i, f, g, o = sig, sig, act, sig of (x W + h U + b), the gates in that
//                order of W's and U's 4H columns
//   c' = f c + i g,  h' = o act(c')
// layer 2 on layer 1's h' of the same step; then logits = h_last Wo + bo,
// probs = act_out(logits) (softmax, sigmoid or linear over D), and probs is
// the next x. probs and logits leave time-major, (T, B, D). Everything is
// float32.
//
// Layout. One cluster of C CTAs (512 threads each, one an SM) owns `rows`
// batch rows for all T steps. CTA c owns the hidden units [c Hc, (c+1) Hc)
// of each layer, Hc = H / C: their 4 Hc gate columns of W_l and U_l, and rows
// [c Hc, (c+1) Hc) of Wo. Each CTA holds the whole x and h of its rows in
// shared memory, feature-major (depth, rows rounded to 8), as B's chain does;
// c of its own units never leaves the CTA. A thread of split 0 (the owner)
// owns one unit's four gates on 8 rows; `splits` threads share each such
// tile's depth, their partials summed in split order (gru_reduce). A layer's
// step is one product phase over the depth segments [x | h] (layer 1's x the
// fed-back probs, D zero-padded to a whole chunk; layer 2's x layer 1's h'),
// the cell in the owner's registers, one exchange of h' (16-byte stores into
// every peer's h tile through distributed shared memory) and one cluster
// barrier: half of B's barriers, whose GRU cell needs r before its second
// product.
//
// One barrier a layer-step leaves a hazard B does not have: a CTA that is
// done with its product would write h' into a peer's h tile while the peer
// still reads the old h for its own. Each layer therefore holds two h tiles
// that alternate by step (NB = 2): step t reads tile t % 2 and writes its
// h' into the other, which no CTA reads before the barrier that ends the
// step's layer (its last reader, the layer's product of step t - 1, ended
// before the barrier every writer has passed). The other build pays a
// second cluster barrier a layer-step (NB = 1, between the product and the
// write) and keeps one tile; ops/_layout.py::lstm_decode_plan names the one
// the H100 ran faster (PERF.md, Findings).
//
// The readout, as B's: after the last layer's cell each CTA computes its
// partial logits (rows, D) over its own Hc units of h' and Wo's own rows and
// pushes them, into its slot of every peer's partials, in that layer's
// exchange. After the barrier every CTA sums the C partials in cluster-rank
// order, adds bo and runs the output activation itself, so it holds the
// whole next x and nothing feeds back through an exchange. A 1-layer head
// with two h tiles also alternates two partials buffers by step (its next
// push comes before any other barrier).
//
// The weights' slices stream from L2 at every step through one ring of
// `stages` chunks of `chunk` depth rows x 4 Hc columns that runs on across
// the layers and steps. The wrapper packs each CTA's slice of [W_l ; U_l]
// so that a chunk is one contiguous block (ops/lstm_decode.py::
// pack_lstm_slices; layer 1's x depth zero-padded to whole chunks), and one
// thread asks the Tensor Memory Accelerator for it (cp.async.bulk, its
// completion counted on the slot's mbarrier). Products are FFMA
// (gru_product), as in B's chain: a tensor-core decode chain lost at these
// row counts (PERF.md, Findings PR 20).
//
// What bounds it: the serial chain, T steps of one product a layer and its
// cluster barrier, and the slices' reads from L2 at every step (every
// cluster reads every weight once a step); ops/_layout.py::lstm_decode_plan
// picks C, the rows a cluster takes, the splits, the chunk and the ring's
// stages. Every kernel launches on the caller's stream and allocates
// nothing.
#pragma once

#include "gru_decode_chain.cuh"

namespace mvt {

struct LstmDecodeChainArgs {
  const float* start;  // (B, D)
  const float* h0[2];  // (B, H) a layer; [1] null in a 1-layer head
  const float* c0[2];  // (B, H) a layer
  // each layer's slice of [W_l ; U_l] packed per CTA (C, depth_l, 4 Hc):
  // depth_1 = D padded to whole chunks + H, depth_2 = 2H; a chunk of a CTA
  // is one contiguous block (ops/lstm_decode.py::pack_lstm_slices)
  const float* slices[2];
  const float* b[2];  // (4H,) a layer
  const float* wo;    // (H, D)
  const float* bo;    // (D,)
  float* probs;       // (T, B, D)
  float* logits;      // (T, B, D)
  int T, B, D, H;
  int rows;    // batch rows a cluster
  int splits;  // threads sharing a tile's depth
  int stages;  // chunks in the ring
  int chunk;   // depth rows of a chunk
};

// partial-logits buffers: two in a 1-layer head with two h tiles a layer
__host__ __device__ constexpr int lstm_dec_pbufs(int NL, int NB) {
  return NL == 1 && NB == 2 ? 2 : 1;
}

// Shared memory of an LSTM decode chain CTA, in bytes: the ring | x (Dp, R8)
// | logits (Dq, R8) | NB h tiles a layer (H, R8) | the partial logits
// (pbufs, C, R8, Dq) | Wo's own rows (Hc, Dq) | c of the own units a layer
// (Hc, R8) | the splits' partials (S - 1, ntiles, kTileStride), float.
// ops/_layout.py's lstm_decode_smem computes the same.
__host__ __device__ constexpr size_t lstm_decode_chain_smem(int NL, int D, int H, int C, int rows,
                                                            int splits, int stages, int chunk,
                                                            int NB) {
  const size_t Hc = H / C, R8 = round8(rows), Dq = dec_dq(D);
  return 4 * ((size_t)stages * chunk * 4 * Hc + (size_t)dec_dp(D, chunk) * R8 + Dq * R8 +
              (size_t)NL * NB * H * R8 + (size_t)lstm_dec_pbufs(NL, NB) * C * R8 * Dq +
              Hc * Dq + (size_t)NL * Hc * R8 +
              (size_t)(splits - 1) * Hc * (R8 / 8) * kTileStride);
}

// Grid: clusters * C CTAs of kChainThreads, cluster dims (C, 1, 1).
template <int NL, int ACT, int OUT, int NB>
__global__ void __launch_bounds__(kChainThreads, 1) lstm_decode_chain_kernel(
    const LstmDecodeChainArgs a) {
  extern __shared__ __align__(16) unsigned char lstm_dec_smem_raw[];
  constexpr int PB = lstm_dec_pbufs(NL, NB);
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
  float* ring = reinterpret_cast<float*>(lstm_dec_smem_raw);
  float* xs = ring + (size_t)a.stages * K * 4 * Hc;
  float* ls = xs + (size_t)Dp * R8;
  float* hbase = ls + (size_t)Dq * R8;
  float* ps = hbase + (size_t)NL * NB * H * R8;
  float* wos = ps + (size_t)PB * C * R8 * Dq;
  float* cs = wos + (size_t)Hc * Dq;
  float* part = cs + (size_t)NL * Hc * R8;
  auto hs = [&](int l, int b) { return hbase + (size_t)(l * NB + b) * H * R8; };

  // the chunks of a step: layer 1's [x | h] (nx + nh), layer 2's (2 nh)
  const int nx = Dp / K, nh = H / K, n1 = nx + nh;
  const int per_step = n1 + (NL == 2 ? 2 * nh : 0), total_chunks = T * per_step;
  const size_t slot_elems = (size_t)K * 4 * Hc;
  __shared__ unsigned long long bars[kDecMaxStages];  // a slot's transfers
  // chunk j of the sequence (thread 0 alone): layer l's ch-th block of K x
  // 4 Hc floats, into slot j % stages
  auto copy_chunk = [&](int j) {
    const int js = j % per_step;
    const int l = js < n1 ? 0 : 1, ch = l ? js - n1 : js;
    const int depth = l ? 2 * H : Dp + H;
    const float* src = a.slices[l] + ((size_t)c * depth + (size_t)ch * K) * 4 * Hc;
    const unsigned bytes = K * 4 * Hc * sizeof(float);
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
    const size_t n4 = ((size_t)Dp * R8 + (size_t)Dq * R8 + (size_t)NL * NB * H * R8 +
                       (size_t)PB * C * R8 * Dq + (size_t)Hc * Dq + (size_t)NL * Hc * R8) / 4;
    for (size_t i = tid; i < n4; i += blockDim.x) p[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    if (row0 + r < B) xs[(size_t)d * R8 + r] = a.start[(size_t)(row0 + r) * D + d];
  }
  for (int l = 0; l < NL; ++l) {
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H, k = i % H;
      if (row0 + r < B) hs(l, 0)[(size_t)k * R8 + r] = a.h0[l][(size_t)(row0 + r) * H + k];
    }
    // c of the own units, (Hc, R8)
    for (int i = tid; i < rows * Hc; i += blockDim.x) {
      const int r = i / Hc, k = i % Hc;
      if (row0 + r < B) {
        cs[((size_t)l * Hc + k) * R8 + r] = a.c0[l][(size_t)(row0 + r) * H + c * Hc + k];
      }
    }
  }
  for (int i = tid; i < Hc * D; i += blockDim.x) {
    const int k = i / D, d = i % D;
    wos[(size_t)k * Dq + d] = a.wo[(size_t)(c * Hc + k) * D + d];
  }
  // every CTA's tiles are set before a peer writes into them
  cluster_arrive();
  cluster_wait();

  // one segment's product: acc (not zeroed here) += the tile (depth rows)
  // . the four gate columns of the segment's n chunks, over the thread's
  // split of each chunk's depth
  int chunk_seq = 0;  // chunks consumed so far (over all steps)
  const int cols4[4] = {ul, Hc + ul, 2 * Hc + ul, 3 * Hc + ul};
  auto segment = [&](const float* src_tile, int n, float (&acc)[4][8]) {
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
        gru_product<4>(src_tile, R8, ro, ring + (size_t)(chunk_seq % a.stages) * slot_elems,
                       4 * Hc, cols4, k0, k0 + per, ch * K, acc);
      }
      ++chunk_seq;
    }
  };
  const size_t own = (size_t)c * Hc * R8;  // the CTA's columns of an h tile, in floats
  // the CTA's share of the output columns
  const int dper = (D + C - 1) / C, d_lo = c * dper, d_hi = min(D, d_lo + dper);

  for (int t = 0; t < T; ++t) {
    const int cur = NB == 2 ? (t & 1) : 0, nxt = NB == 2 ? cur ^ 1 : 0;
    float* pbuf = ps + (PB == 2 ? (size_t)(t & 1) * C * R8 * Dq : 0);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      // [x | h] . [W_l ; U_l]: x the fed-back probs or layer 1's h' of the step
      float acc[4][8] = {};
      segment(l ? hs(0, nxt) : xs, l ? nh : nx, acc);
      segment(hs(l, cur), nh, acc);
      gru_reduce(acc, part, S, ntiles, tile, split);
      if constexpr (NB == 1) {
        // every CTA of the cluster is done reading the layer's h tile
        cluster_arrive();
        cluster_wait();
      }
      float* h = hs(l, nxt);
      if (owner) {
        float* cr = cs + ((size_t)l * Hc + ul) * R8 + 8 * ro;
        float* hr = h + (size_t)unit * R8 + 8 * ro;
        // the bias from L1 (held in registers, it made the 1-layer
        // instances spill)
        const float* bl = a.b[l] + unit;
        const float bi = bl[0], bf = bl[H], bg = bl[2 * H], bo = bl[3 * H];
        float cv[8], hv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float ig = activate<kSigmoid>(acc[0][r] + bi);
          const float fg = activate<kSigmoid>(acc[1][r] + bf);
          const float gg = activate<ACT>(acc[2][r] + bg);
          const float og = activate<kSigmoid>(acc[3][r] + bo);
          cv[r] = fg * cr[r] + ig * gg;
          hv[r] = 8 * ro + r < rows ? og * activate<ACT>(cv[r]) : 0.0f;
        }
        *reinterpret_cast<float4*>(cr) = make_float4(cv[0], cv[1], cv[2], cv[3]);
        *reinterpret_cast<float4*>(cr + 4) = make_float4(cv[4], cv[5], cv[6], cv[7]);
        *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<float4*>(hr + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
      }
      __syncthreads();  // the CTA's columns of h' are in its tile
      if (l == NL - 1) {
        // the readout's partial logits over the CTA's units, into its slot
        float* slot = pbuf + (size_t)c * R8 * Dq;
        const float* hc = h + own;
        for (int i = tid; i < rows * D; i += blockDim.x) {
          const int r = i / D, d = i % D;
          float s = 0.0f;
          for (int k = 0; k < Hc; ++k) s = fmaf(hc[(size_t)k * R8 + r], wos[(size_t)k * Dq + d], s);
          slot[(size_t)r * Dq + d] = s;
        }
        __syncthreads();
        push_columns(cluster, reinterpret_cast<char*>(pbuf), R8 * Dq / 4,
                     [&](int j) { return ((size_t)c * R8 * Dq + 4 * j) * 4; }, C, c);
      }
      // the exchange of h'
      push_columns(cluster, reinterpret_cast<char*>(h), Hc * R8 / 4,
                   [&](int j) { return own * 4 + (size_t)16 * j; }, C, c);
      cluster_arrive();
      cluster_wait();
    }
    // the readout: the partials summed in rank order, bo, the activation
    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float s = a.bo[d];
      for (int cc = 0; cc < C; ++cc) s += pbuf[((size_t)cc * R8 + r) * Dq + d];
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
        for (int d = lane; d < D; d += 32) xs[(size_t)d * R8 + r] /= s;
      }
    } else {
      for (int i = tid; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        xs[(size_t)d * R8 + r] = activate<OUT>(ls[(size_t)d * R8 + r]);
      }
    }
    __syncthreads();
    // the CTA's columns of the step's probs and logits
    const int dn = d_hi - d_lo;
    for (int i = tid; i < rows * dn; i += blockDim.x) {
      const int r = i / dn, d = d_lo + i % dn;
      if (row0 + r >= B) continue;
      const size_t o = ((size_t)t * B + row0 + r) * D + d;
      a.probs[o] = xs[(size_t)d * R8 + r];
      a.logits[o] = ls[(size_t)d * R8 + r];
    }
  }
}

// The chain of one head at the plan of ops/_layout.py::lstm_decode_plan
// (cluster size, rows a cluster, splits, stages, chunk, NB h tiles a layer);
// cudaErrorInvalidValue for a plan it does not run.
template <int NL, int ACT, int OUT, int NB>
int launch_lstm_decode_chain(const LstmDecodeChainArgs& a, int cluster, void* stream) {
  const int H = a.H, S = a.splits;
  if (a.T < 1 || a.B < 1 || a.D < 1 || cluster < 1 || cluster > kMaxCluster || H < 32 ||
      (a.chunk != 32 && a.chunk != 64 && a.chunk != 128) || H % a.chunk != 0 ||
      H % cluster != 0 || (H / cluster) % 4 != 0 || a.rows < 1 || S < 1 ||
      (S & (S - 1)) != 0 || S > kDecMaxSplits || a.chunk % S != 0 || a.stages < 2 ||
      a.stages > kDecMaxStages) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < NL; ++l) {
    if (a.slices[l] == nullptr || (reinterpret_cast<size_t>(a.slices[l]) & 15) != 0 ||
        a.h0[l] == nullptr || a.c0[l] == nullptr || a.b[l] == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int tiles = H / cluster * (round8(a.rows) / 8);
  if (tiles * S > kChainThreads) return (int)cudaErrorInvalidValue;
  // the ring's mbarriers take static shared memory beside the dynamic
  const size_t smem =
      lstm_decode_chain_smem(NL, a.D, H, cluster, a.rows, S, a.stages, a.chunk, NB);
  if (smem > kDecSmem) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_decode_chain_kernel<NL, ACT, OUT, NB>;
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
