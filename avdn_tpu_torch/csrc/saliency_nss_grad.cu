// The gradient of -NSS with respect to the predicted saliency map, written by
// hand for Hopper (sm_90a): the backward of the fused saliency kernel
// (saliency_stats.cu) on the training path.
//
// Replaces: no Pallas kernel. The JAX package trains through XLA's autodiff
// of avdn_tpu/ops/saliency_pallas.py:saliency_stats_xla and the tail of
// saliency_reductions (its Pallas kernel has no VJP: use_pallas=False under
// train, avdn_tpu/rollout/engine.py:285-288). This kernel computes that
// gradient in closed form. With n pixels, per item sums Sp, Sp2, Spg, Sg (the
// forward's stats row), mean = Sp/n, var = (Sp2 - n*mean*mean)/(n-1),
// std = sqrt(max(var, 0)), z = (Spg - mean*Sg)/std and upstream u = dL/d(-NSS):
//
//   dL/dp_i = -c*u/(Sg + 0.001) * [ (g_i - Sg/n)/std - z*(p_i - mean)/((n-1)*std^2) ]
//
// with c = 1, or 1/2 for nss_r = +-1 (the +-Sg term does not depend on p).
// Where std == 0 the forward takes the where(std > 0, std, 1) branch and the
// item is invalid: the gradient is exactly 0 there (XLA's autodiff gives
// 0 * inf = NaN through sqrt's derivative; the port gives the masked loss's
// zero). Items whose upstream is 0 (the loss masks invalid ones) are 0 too.
//
// Bound on this card: bytes. It reads p and g and writes dL/dp, 12 bytes per
// pixel: 4.8 MB at B = 8 and 224 x 224 (1.4 us at the H100's 3.35 TB/s),
// 48 MB at the fused teacher's N = T*B = 80. Design: a grid of
// (chunks, items); each of 256 threads issues kUnroll = 4 independent 16-byte
// loads of each map, neighbouring threads on neighbouring addresses, and
// writes 16 bytes per load pair. Each thread derives the item's two
// coefficients from its stats row (five floats, served from L1/L2), so no
// second launch and no shared memory are needed.
//
// Plain C interface (loaded with ctypes): the launch returns the CUDA error of
// the launch so the wrapper can raise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kPerBlock = kThreads * kUnroll;  // float4s per block

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__global__ void __launch_bounds__(kThreads)
nss_grad_kernel(const float4* __restrict__ pred, const float4* __restrict__ gt,
                const float* __restrict__ stats, const float* __restrict__ upstream,
                float4* __restrict__ grad, int n, int nss_r) {
  const int item = blockIdx.y;
  const long long n4 = n / 4;
  const float* row = stats + static_cast<long long>(item) * 8;
  const float sp = row[0], sp2 = row[1], spg = row[2], sg = row[3];
  const float u = upstream[item];

  // the forward's mean, var and std, with the same single roundings
  const float fn = static_cast<float>(n);
  const float mean = __fdiv_rn(sp, fn);
  const float var = __fdiv_rn(__fsub_rn(sp2, __fmul_rn(__fmul_rn(fn, mean), mean)),
                              static_cast<float>(n - 1));
  const float std = __fsqrt_rn(clamp_min(var, 0.f));
  float a = 0.f, b = 0.f, gmean = 0.f;
  if (std > 0.f && u != 0.f) {
    const float z = __fdiv_rn(__fsub_rn(spg, __fmul_rn(mean, sg)), std);
    const float c = nss_r == 0 ? 1.f : 0.5f;
    const float k = __fdiv_rn(__fmul_rn(-c, u), __fadd_rn(sg, 0.001f));
    a = __fdiv_rn(k, std);
    b = __fdiv_rn(__fmul_rn(k, z),
                  __fmul_rn(static_cast<float>(n - 1), __fmul_rn(std, std)));
    gmean = __fdiv_rn(sg, fn);
  }

  const float4* p = pred + item * n4;
  const float4* g = gt + item * n4;
  float4* out = grad + item * n4;
  const long long base = static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x;
  float4 pv[kUnroll], gv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long j = base + k * kThreads;
    if (j < n4) {
      pv[k] = __ldg(p + j);
      gv[k] = __ldg(g + j);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long j = base + k * kThreads;
    if (j < n4) {
      float4 r;
      r.x = a * (gv[k].x - gmean) - b * (pv[k].x - mean);
      r.y = a * (gv[k].y - gmean) - b * (pv[k].y - mean);
      r.z = a * (gv[k].z - gmean) - b * (pv[k].z - mean);
      r.w = a * (gv[k].w - gmean) - b * (pv[k].w - mean);
      out[j] = r;
    }
  }
}

}  // namespace

// pred, gt, grad: (batch, n) contiguous float32, 16-byte aligned, n % 4 == 0;
// stats: (batch, 8) rows of the forward kernel; upstream: (batch,) dL/d(-NSS).
// nss_r in {-1, 0, 1}. Returns the CUDA error code of the launch.
extern "C" int saliency_nss_grad_launch(const void* pred, const void* gt,
                                        const void* stats, const void* upstream,
                                        void* grad, int batch, int n, int nss_r,
                                        void* stream) {
  if (batch <= 0) return 0;
  if (n < 8 || n % 4 != 0 || batch > 65535 || nss_r < -1 || nss_r > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n4 = n / 4;
  const dim3 grid(static_cast<unsigned>((n4 + kPerBlock - 1) / kPerBlock), batch, 1);
  nss_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pred), static_cast<const float4*>(gt),
      static_cast<const float*>(stats), static_cast<const float*>(upstream),
      static_cast<float4*>(grad), n, nss_r);
  return static_cast<int>(cudaGetLastError());
}
