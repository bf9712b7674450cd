// Fused per-item saliency statistics and their NSS / HA tail, written by hand
// for Hopper (sm_90a).
//
// Replaces: avdn_tpu/ops/saliency_pallas.py:saliency_stats_pallas (kernel
// body _stats_kernel) — one pass over each item's predicted and ground-truth
// saliency maps giving the (B, 8) row
//   [sum p, sum p^2, sum p*g, sum g, sum clip(p,0,1)*g, sum clip(p,0,1), 0, 0]
// — and the tail of avdn_tpu/ops/saliency_pallas.py:saliency_reductions,
// which turns each row into -NSS, its validity flag and the human-attention
// precision and recall (avdn_tpu_torch/ops/saliency.py:reductions_from_stats).
//
// Bound on this card: bytes. It reads 2*B*H*W*4 bytes (3.2 MB at the main
// path's B = 8 and 224 x 224, 0.96 us at the H100's 3.35 TB/s) and writes
// B*45; its 8 flops per pixel pair are far below the fp32 rate.
//
// Design, against the three limits of one block per item:
// 1. Too few SMs at small B. Each item is split across a thread-block
//    cluster of C blocks (grid (C, B), cluster (C, 1, 1), launched with
//    cudaLaunchKernelEx); the host picks C, a power of two up to the
//    portable cluster size 8, that keeps the grid within one wave of
//    resident blocks (ops/saliency.py:cluster_size). Rank r reduces the
//    contiguous float4 slice [r*n4/C, (r+1)*n4/C) of its item, which covers
//    a ragged edge.
// 2. Too few bytes in flight. Each of 512 threads issues kUnroll = 4
//    independent 16-byte loads of each map before it adds, neighbouring
//    threads on neighbouring addresses: 64 KB in flight per block. The six
//    fp32 sums stay in registers.
// 3. The tail in separate launches. Each rank stores its six partial sums
//    into rank 0's shared memory (distributed shared memory), one cluster
//    barrier later rank 0 adds them in rank order and evaluates the tail in
//    the epilogue with one rounding per operation
//    (__fmul_rn and friends: no FMA contraction), in the plain version's
//    order. No atomics and no second launch: the result is bitwise the same
//    from run to run.
//
// Plain C interface (loaded with ctypes): the launch returns the CUDA error
// of the launch (a refused cluster launch included) so the wrapper can raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kStats = 6;
constexpr int kMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ void accumulate(float (&s)[kStats], float p, float g) {
  // clip with NaN passing through, like torch.clamp and jnp.clip
  const float pc = p < 0.f ? 0.f : (p > 1.f ? 1.f : p);
  s[0] += p;
  s[1] = fmaf(p, p, s[1]);
  s[2] = fmaf(p, g, s[2]);
  s[3] += g;
  s[4] = fmaf(pc, g, s[4]);
  s[5] += pc;
}

// The split cluster barrier: arrive without ordering (this block has
// started), and wait for the other blocks' arrivals.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// clamp(x, min=lo) as torch computes it: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__global__ void __launch_bounds__(kThreads)
saliency_fused_kernel(const float4* __restrict__ pred, const float4* __restrict__ gt,
                      float* __restrict__ stats, float* __restrict__ red,
                      unsigned char* __restrict__ valid, int batch, int n, int nss_r) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const int item = blockIdx.y;
  const long long n4 = n / 4;
  const long long lo = rank * n4 / csize;
  const long long hi = (rank + 1) * n4 / csize;
  const float4* p = pred + item * n4;
  const float4* g = gt + item * n4;
  cluster_arrive_relaxed();

  float s[kStats] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads * kUnroll) {
    float4 pv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      pv[u] = j < hi ? __ldg(p + j) : zero;
      gv[u] = j < hi ? __ldg(g + j) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // zeros add nothing to any sum
      accumulate(s, pv[u].x, gv[u].x);
      accumulate(s, pv[u].y, gv[u].y);
      accumulate(s, pv[u].z, gv[u].z);
      accumulate(s, pv[u].w, gv[u].w);
    }
  }

  // block partials: warp shuffles, then one pass through shared memory;
  // thread 0 ends with the block's six sums
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  }
  __shared__ float warp_part[kWarps][kStats];
  __shared__ float cluster_part[kMaxCluster][kStats];  // read on rank 0 only
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) warp_part[warp][k] = s[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) {
      s[k] = lane < kWarps ? warp_part[lane][k] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
    }
  }

  // cluster partials: each rank pushes its sums into rank 0's shared memory
  // (a shared-memory window may be written only once its block has started:
  // the relaxed arrive at the top and this wait), then one cluster barrier
  // with release / acquire makes them visible to rank 0
  cluster_wait();
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(&cluster_part[rank][0], 0);
#pragma unroll
    for (int k = 0; k < kStats; ++k) dst[k] = s[k];
  }
  cluster.sync();
  if (rank != 0 || threadIdx.x != 0) return;
  float item_sum[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    item_sum[k] = cluster_part[0][k];
    for (unsigned r = 1; r < csize; ++r) item_sum[k] += cluster_part[r][k];  // rank order
  }

  // the tail, in reductions_from_stats's order with single roundings
  const float sp = item_sum[0], sp2 = item_sum[1], spg = item_sum[2];
  const float sg = item_sum[3], spcg = item_sum[4], spc = item_sum[5];
  float* row = stats + static_cast<long long>(item) * 8;
#pragma unroll
  for (int k = 0; k < kStats; ++k) row[k] = item_sum[k];
  row[6] = 0.f;
  row[7] = 0.f;

  const float fn = static_cast<float>(n);
  const float mean = __fdiv_rn(sp, fn);
  const float var = __fdiv_rn(__fsub_rn(sp2, __fmul_rn(__fmul_rn(fn, mean), mean)),
                              static_cast<float>(n - 1));
  const float std = __fsqrt_rn(clamp_min(var, 0.f));
  float z_dot = __fdiv_rn(__fsub_rn(spg, __fmul_rn(mean, sg)), std > 0.f ? std : 1.f);
  if (nss_r == 1) {
    z_dot = __fadd_rn(__fdiv_rn(z_dot, 2.f), sg);
  } else if (nss_r == -1) {
    z_dot = __fsub_rn(__fdiv_rn(z_dot, 2.f), sg);
  }
  const float nss = __fdiv_rn(z_dot, __fadd_rn(sg, 0.001f));
  red[item] = -nss;
  red[batch + item] = spc > 0.f ? __fdiv_rn(spcg, clamp_min(spc, 1e-20f)) : 0.f;
  red[2 * batch + item] = __fdiv_rn(spcg, clamp_min(sg, 1e-20f));
  valid[item] = (sg > 0.f) && isfinite(nss) && (std > 0.f);
}

}  // namespace

// pred, gt: (batch, n) contiguous float32, 16-byte aligned, n % 4 == 0.
// Outputs: stats (batch, 8) float32; red (3, batch) float32 rows -NSS,
// precision, recall; valid (batch,) uint8. nss_r in {-1, 0, 1}; cluster a
// power of two <= 8. Returns the CUDA error code of the launch.
extern "C" int saliency_fused_launch(const void* pred, const void* gt, void* stats,
                                     void* red, void* valid, int batch, int n,
                                     int nss_r, int cluster, void* stream) {
  if (batch <= 0) return 0;
  if (n < 4 || n % 4 != 0 || batch > 65535 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || nss_r < -1 || nss_r > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, saliency_fused_kernel, static_cast<const float4*>(pred),
      static_cast<const float4*>(gt), static_cast<float*>(stats), static_cast<float*>(red),
      static_cast<unsigned char*>(valid), batch, n, nss_r);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
