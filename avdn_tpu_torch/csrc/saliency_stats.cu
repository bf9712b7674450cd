// Fused per-item saliency statistics, written by hand for Hopper (sm_90a).
//
// Replaces: avdn_tpu/ops/saliency_pallas.py:saliency_stats_pallas (kernel
// body _stats_kernel) — one pass over each item's predicted and ground-truth
// saliency maps giving the (B, 8) row
//   [sum p, sum p^2, sum p*g, sum g, sum clip(p,0,1)*g, sum clip(p,0,1), 0, 0]
// from which saliency_reductions derives -NSS, its validity flag and the
// human-attention precision and recall (avdn_tpu_torch/ops/saliency.py).
//
// Bound on this card: bytes. It reads 2*B*H*W*4 bytes and writes B*32; at the
// main path's (B, 224, 224) that is 3.2 MB for B = 8, about 0.96 us at the
// H100's 3.35 TB/s — against a launch of several microseconds, so at this
// size the kernel is launch-bound. The arithmetic (8 flops per pixel pair)
// is far below the card's fp32 rate.
//
// Design: one block per item, 256 threads striding over the item's H*W
// values with 16-byte float4 loads (neighbouring threads on neighbouring
// addresses), six fp32 sums per thread in registers, a warp-shuffle
// reduction, then one across the 8 warps through shared memory; thread 0
// writes the item's 8 floats. No allocation and no synchronisation with the
// host: the wrapper allocates the output and launches on PyTorch's current
// stream. One block per item fills only B of the 132 SMs; splitting an item
// across blocks, and the fused teacher path's T*B launch, are later work.
//
// Plain C interface (loaded with ctypes): the launch returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStats = 6;

__device__ __forceinline__ void accumulate(float (&s)[kStats], float p, float g) {
  // clip with NaN passing through, like jnp.clip
  const float pc = p < 0.f ? 0.f : (p > 1.f ? 1.f : p);
  s[0] += p;
  s[1] = fmaf(p, p, s[1]);
  s[2] = fmaf(p, g, s[2]);
  s[3] += g;
  s[4] = fmaf(pc, g, s[4]);
  s[5] += pc;
}

__global__ void __launch_bounds__(kThreads)
saliency_stats_kernel(const float4* __restrict__ pred,
                      const float4* __restrict__ gt,
                      float* __restrict__ out, int n4) {
  const size_t base = static_cast<size_t>(blockIdx.x) * n4;
  float s[kStats] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 p = __ldg(pred + base + i);
    const float4 g = __ldg(gt + base + i);
    accumulate(s, p.x, g.x);
    accumulate(s, p.y, g.y);
    accumulate(s, p.z, g.z);
    accumulate(s, p.w, g.w);
  }
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
    }
  }
  __shared__ float partial[kWarps][kStats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) partial[warp][k] = s[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) {
      float v = lane < kWarps ? partial[lane][k] : 0.f;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      s[k] = v;
    }
    if (lane == 0) {
      float* row = out + static_cast<size_t>(blockIdx.x) * 8;
#pragma unroll
      for (int k = 0; k < kStats; ++k) row[k] = s[k];
      row[6] = 0.f;
      row[7] = 0.f;
    }
  }
}

}  // namespace

// pred, gt: (batch, n) contiguous float32, 16-byte aligned, n % 4 == 0;
// out: (batch, 8) float32. Returns the CUDA error code of the launch.
extern "C" int saliency_stats_launch(const void* pred, const void* gt, void* out,
                                     int batch, int n, void* stream) {
  if (batch <= 0) return 0;
  saliency_stats_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pred), static_cast<const float4*>(gt),
      static_cast<float*>(out), n / 4);
  return static_cast<int>(cudaGetLastError());
}
