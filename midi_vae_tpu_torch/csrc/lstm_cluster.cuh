// The pieces the LSTM's two serial chains on thread-block clusters share:
// the backward's (lstm_cell_bwd.cuh, kernels N and R) and the forward's
// (lstm_cell_fwd.cuh, kernels Q and Y). A chain runs 512-thread CTAs, one an
// SM, in clusters of up to 16 (a non-portable size above 8); each CTA keeps
// its slice of U in shared memory (copied with cp.async, or streamed through
// a cp.async ring where it does not fit) and the CTAs of a cluster meet at
// one cluster barrier a step. The bf16 builds take their products on the
// tensor cores with mma.sync m16n8k16 (float accumulators).
#pragma once

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace mvt {

namespace cg = cooperative_groups;

constexpr int kChainThreads = 512;
constexpr int kChainWarps = kChainThreads / 32;
// the largest cluster (16: a non-portable size)
constexpr int kMaxCluster = 16;

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of the thread's committed copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ unsigned ld_b32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a . b on the tensor cores: a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B
// fragment, float accumulators
__device__ __forceinline__ void mma_bf16(float c[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The bf16 builds' slice: U restricted to the CTA's gate columns, (H, 4 Hc)
// with unit n's row n holding its 4 Hc gate columns (local gl = q Hc + u is
// U column q H + c Hc + u), each 16-byte chunk j of a row stored at chunk
// j ^ (n % 8): the fragment loads of 8 neighbouring rows (the backward's mma
// B fragments of 8 units, the forward's ldmatrix of 8 depths) then read 8
// different chunks, so 32 banks.
__device__ __forceinline__ void copy_slice_u(const bf16* __restrict__ u, bf16* dst, int H,
                                             int Hc, int c) {
  const int G4 = 4 * Hc, chunks = G4 / 8;
  for (int i = threadIdx.x; i < H * chunks; i += blockDim.x) {
    const int n = i / chunks, j = i % chunks;
    const int q = 8 * j / Hc, u0 = 8 * j % Hc;
    cp_async16(dst + (size_t)n * G4 + ((j ^ (n & 7)) << 3),
               u + (size_t)n * 4 * H + q * H + c * Hc + u0);
  }
}

// the dynamic shared memory and (above 8) the non-portable cluster size of
// a chain kernel
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// a launch configuration of `grid` CTAs of a chain in clusters of `cluster`
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int grid, int cluster, size_t smem, void* stream) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kChainThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// cudaOccupancyMaxActiveClusters of a chain kernel at `cluster` CTAs a
// cluster, each with the whole of a block's shared memory (one CTA an SM)
template <typename Kernel>
int max_active_clusters(Kernel kernel, int cluster, int* out) {
  const size_t smem = 232448;
  cudaError_t err = cluster_config(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, cluster, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

}  // namespace mvt
