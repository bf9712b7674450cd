// The gradient of -NSS with respect to the (N, 8, 8) saliency head, written
// by hand for Hopper (sm_90a): the backward of the saliency upsample
// (models/layers.py:saliency_upsample, (N, 8, 8) -> (N, H, W) bilinear) and
// of the fused saliency kernel's -NSS (saliency_stats.cu) in one launch.
//
// Replaces: no Pallas kernel. The JAX package trains through XLA's autodiff
// of avdn_tpu/ops/saliency_pallas.py:saliency_stats_xla, the tail of
// saliency_reductions and jax.image.resize (avdn_tpu/models/layers.py:126-131;
// the Pallas kernel has no VJP: use_pallas=False under train,
// avdn_tpu/rollout/engine.py:285-288). Before this kernel the port wrote the
// full-resolution dL/dpred and let the upsample's backward (ATen's atomic
// scatter in fp32, a cast and two batched matmuls in bf16) reduce it.
//
// What it computes, per item, in the plain version's order
// (ops/saliency.py:saliency_head_grad_plain). With n = H*W pixels, the
// forward's stats row (Sp, Sp2, Spg, Sg), mean = Sp/n,
// var = (Sp2 - n*mean*mean)/(n-1), std = sqrt(max(var, 0)),
// z = (Spg - mean*Sg)/std, upstream u = dL/d(-NSS), c = 1 (1/2 for
// nss_r = +-1), k = -c*u/(Sg + 0.001):
//   1. p, the upsampled prediction, rebuilt from x8 for the rows the block
//      owns: at most two taps per axis (the (8, W) weight table w, the
//      resize weights, rounded to bf16 for a bf16 head). bf16 head: the
//      rows first, each contraction rounded to bf16, as the forward's two
//      einsums round (a product of two bf16 values is exact in fp32, so the
//      two-tap sums round once, as a fp32-accumulating GEMM rounds them).
//      fp32 head: ATen's bilinear formula (columns inside, rows outside);
//      p agrees with F.interpolate to an ulp or two, and enters only
//      through -b*(p - mean).
//   2. dL/dp = a*(g - Sg/n) - b*(p - mean), a = k/std,
//      b = k*z/((n-1)*std^2), with the same single roundings as the
//      forward's tail. std == 0 or u == 0: the gradient is exactly 0 (XLA's
//      autodiff gives 0*inf = NaN through sqrt's derivative where std == 0;
//      the port gives the masked loss's zero).
//      bf16 head: dL/dp rounded to bf16 (the backward of pred.float()).
//   3. The transpose of the forward's contractions: d_rows[p][j] =
//      sum_q dL/dp[p][q]*w[j][q] (lane partials, then a fixed xor-shuffle
//      tree; rounded to bf16 on a bf16 head), then dx8[i][j] =
//      sum_p d_rows[p][j]*w[i][p] over each warp's rows in order, the
//      block's warps in order and the item's blocks in rank order (rounded
//      once at the end on a bf16 head).
//
// Bound on this card: bytes. The only full-resolution input is the GT map,
// 4 bytes a pixel, read once (0.48 us at N = 8 and 224 x 224 at the H100's
// 3.35 TB/s); x8, the stats row, u and dx8 are O(64) an item. About 14
// operations a pixel: far below even the fp32 rate, so the tensor cores do
// not apply. At the train path's N = 8 and 16 the bytes take under a
// microsecond and the kernel's time is latency: one DRAM round trip, the
// chains of dependent instructions inside a block, and the combine across
// blocks. The design keeps each chain short:
// - Rows of an item are split into C contiguous bands, one block each
//   (grid (C, N)); C = 16 at 224 rows fills the SMs at N = 8 (128 blocks).
//   A row belongs to one block, so d_rows is complete inside it.
// - Thread 0 starts two bulk asynchronous copies first thing
//   (cp.async.bulk, completion on one mbarrier): the band's GT rows (a
//   contiguous run) and the (8, W) weight table, into shared memory. While
//   they fly, every thread loads the head, the stats row and u, derives the
//   coefficients and finds its taps (integer arithmetic only: no division,
//   which costs microseconds here).
// - A warp takes a row; a lane a run of W/32 neighbouring columns, whose
//   taps touch at most three head columns: it keeps three partial sums of
//   d_rows instead of eight, and its columns' weights in registers. A
//   halving xor tree (9 shuffles) leaves each group of 4 lanes with one of
//   the row's eight sums, which it adds, weighted, into its warp's partial
//   dx8 in registers; one barrier, and the block's eight warp partials meet
//   in order.
// - The C partial 8x8 blocks of an item are combined in rank order through
//   scratch in global memory and a last-block-done ticket. No atomics touch
//   the result, so repeated launches are bitwise equal; the last block
//   resets its item's counter for the next launch. (A combine through
//   distributed shared memory in a thread-block cluster measured slower at
//   every N on the H100; PERF.md.)
//
// Built with -DHEAD_GRAD_MARKS (tools/phase_saliency_grad.py), thread 0 of
// every block stores clock64() at each phase boundary into g_marks.
//
// Plain C interface (loaded with ctypes): the launch returns the CUDA error of
// the launch so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef HEAD_GRAD_MARKS
constexpr int kMarkSlots = 16;
__device__ long long g_marks[65536 * kMarkSlots];
#define MARK(k)                                                                   \
  if (threadIdx.x == 0)                                                           \
    g_marks[(blockIdx.y * gridDim.x + blockIdx.x) * kMarkSlots + (k)] = clock64()
#else
#define MARK(k)
#endif

namespace {

constexpr int kHead = 8;                  // the head is kHead x kHead
constexpr int kHead2 = kHead * kHead;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHW = 256;               // H = W <= 256, a multiple of 32
constexpr int kMaxCols = kMaxHW / 32;     // columns per lane
constexpr int kSpan = 3;                  // head columns a lane's columns touch
constexpr int kMinBlocks = 8;             // bands per item: 8 ...
constexpr int kMaxBlocks = 32;            // ... to 32
constexpr int kMaxBandRows = kMaxHW / kMinBlocks;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float load_head(const float* p) { return *p; }
__device__ __forceinline__ float load_head(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_head(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_head(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float round_head(float v) { return v; }
template <>
__device__ __forceinline__ float round_head<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The first tap of output index o of n_out from kHead inputs (half-pixel
// centres): the first input with a nonzero weight, floor(num / (2 n_out))
// for num = (2o + 1) kHead - n_out >= 0. The product with the reciprocal
// inv2n = 1/(2 n_out) floors right: for n_out a multiple of 32, num is 8
// mod 16, at least 8/(2 n_out) away from a multiple of 2 n_out.
__device__ __forceinline__ int first_tap(int o, int n_out, float inv2n) {
  const int num = (2 * o + 1) * kHead - n_out;
  const int i0 = num < 0 ? 0 : static_cast<int>(static_cast<float>(num) * inv2n);
  return i0 < kHead - 1 ? i0 : kHead - 1;
}

// Its two taps' weights from the (kHead, n_out) table w in shared memory:
// at i0 and at i0 + 1 (0 at the top edge).
__device__ __forceinline__ void tap_weights(const float* w, int o, int n_out, int i0,
                                            float& w0, float& w1) {
  w0 = w[i0 * n_out + o];
  w1 = i0 + 1 < kHead ? w[(i0 + 1) * n_out + o] : 0.f;
}

// The sums over a warp's 32 lanes of eight values each, by halving: at
// each of the xor offsets 16, 8, 4 a lane keeps half its values, adds its
// partner's of that half and passes on the other; offsets 2 and 1 then add
// within groups of 4. A fixed order, and every lane of a group of 4 ends
// with the same sum, of column lane_column(lane).
__device__ __forceinline__ int lane_column(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ float warp_sum_8(const float (&v)[kHead], int lane) {
  float v4[4], v2[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float send = hi16 ? v[t] : v[t + 4];
    v4[t] = (hi16 ? v[t + 4] : v[t]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float send = hi8 ? v4[t] : v4[t + 2];
    v2[t] = (hi8 ? v4[t + 2] : v4[t]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float v1 = (hi4 ? v2[1] : v2[0]) + __shfl_xor_sync(0xffffffffu, hi4 ? v2[0] : v2[1], 4);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
  return v1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The coefficients of dL/dp from the forward's stats row, with the tail's
// single roundings (a = b = 0 where std == 0 or u == 0).
struct Coeffs {
  float a, b, gmean, mean;
};

__device__ __forceinline__ Coeffs coefficients(float sp, float sp2, float spg, float sg,
                                               float u, int n, int nss_r) {
  const float fn = static_cast<float>(n);
  Coeffs c{0.f, 0.f, 0.f, 0.f};
  c.mean = __fdiv_rn(sp, fn);
  const float var = __fdiv_rn(__fsub_rn(sp2, __fmul_rn(__fmul_rn(fn, c.mean), c.mean)),
                              static_cast<float>(n - 1));
  const float std = __fsqrt_rn(clamp_min(var, 0.f));
  if (std > 0.f && u != 0.f) {
    const float z = __fdiv_rn(__fsub_rn(spg, __fmul_rn(c.mean, sg)), std);
    const float half = nss_r == 0 ? 1.f : 0.5f;
    const float k = __fdiv_rn(__fmul_rn(-half, u), __fadd_rn(sg, 0.001f));
    c.a = __fdiv_rn(k, std);
    c.b = __fdiv_rn(__fmul_rn(k, z),
                    __fmul_rn(static_cast<float>(n - 1), __fmul_rn(std, std)));
    c.gmean = __fdiv_rn(sg, fn);
  }
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_grad_kernel(const T* __restrict__ x8, const float* __restrict__ gt,
                 const float* __restrict__ stats, const float* __restrict__ upstream,
                 const float* __restrict__ w, T* __restrict__ out,
                 float* __restrict__ partial, unsigned* __restrict__ tickets,
                 int hw, int nss_r) {
  extern __shared__ __align__(128) float band[];  // the band's GT rows, then w
  __shared__ __align__(8) uint64_t bar;
  __shared__ float head[kHead2];
  __shared__ float rows[kMaxBandRows][kHead];     // bf16: the contracted head rows
  __shared__ int row_i0[kMaxBandRows];
  __shared__ float row_w0[kMaxBandRows], row_w1[kMaxBandRows];
  __shared__ float warp_part[kWarps][kHead2];     // each warp's rows' partial dx8
  __shared__ bool last;

  const int item = blockIdx.y;
  const int nblocks = gridDim.x;
  const int rank = blockIdx.x;
  const int r0 = rank * hw / nblocks;
  const int nrows = (rank + 1) * hw / nblocks - r0;
  const int n = hw * hw;
  const int cols = hw / 32;  // columns per lane
  const float inv2n = 1.f / static_cast<float>(2 * hw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  MARK(0);
  float* wtab = band + ((hw + nblocks - 1) / nblocks) * hw;  // (kHead, hw) weights

  // ---- the band's and the weight table's copies first ----
  const uint32_t bar_addr = smem_addr(&bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t band_bytes = static_cast<uint32_t>(nrows) * hw * 4;
    const uint32_t w_bytes = static_cast<uint32_t>(kHead) * hw * 4;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_addr), "r"(band_bytes + w_bytes) : "memory");
    const float* src = gt + static_cast<long long>(item) * n + static_cast<long long>(r0) * hw;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(band)), "l"(src), "r"(band_bytes), "r"(bar_addr) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(wtab)), "l"(w), "r"(w_bytes), "r"(bar_addr) : "memory");
  }

  // ---- while they fly: the head, the stats row and u, the coefficients ----
  const float* srow = stats + static_cast<long long>(item) * 8;
  const float sp = __ldg(srow), sp2 = __ldg(srow + 1), spg = __ldg(srow + 2);
  const float sg = __ldg(srow + 3), u = __ldg(upstream + item);
  if (tid < kHead2) head[tid] = load_head(x8 + static_cast<long long>(item) * kHead2 + tid);
  // this lane's columns q = cols*lane + k: taps j0 = jl + e[k], jl + e[k] + 1
  const int jl = first_tap(cols * lane, hw, inv2n);
  bool e[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    e[k] = k < cols && first_tap(cols * lane + k, hw, inv2n) != jl;
  }
  if (tid < nrows) row_i0[tid] = first_tap(r0 + tid, hw, inv2n);
  const Coeffs c = coefficients(sp, sp2, spg, sg, u, n, nss_r);
  MARK(1);
  // thread 0's mbarrier.init is visible to every warp only after a barrier
  // (the word may still hold a completed barrier of an earlier block)
  __syncthreads();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_addr) : "memory");
  }

  MARK(2);
  // ---- the taps' weights from the table ----
  if (tid < nrows) tap_weights(wtab, r0 + tid, hw, row_i0[tid], row_w0[tid], row_w1[tid]);
  float v0[kMaxCols], v1[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    v0[k] = v1[k] = 0.f;
    if (k < cols) tap_weights(wtab, cols * lane + k, hw, jl + e[k], v0[k], v1[k]);
  }
  __syncthreads();
  if (sizeof(T) == 2) {  // rows[r][j] = bf16(w0*x[i0][j] + w1*x[i1][j])
    for (int t = tid; t < nrows * kHead; t += kThreads) {
      const int r = t / kHead, j = t % kHead;
      const int i0 = row_i0[r];
      const int i1 = i0 + 1 < kHead ? i0 + 1 : i0;
      rows[r][j] = round_head<T>(__fadd_rn(__fmul_rn(row_w0[r], head[i0 * kHead + j]),
                                           __fmul_rn(row_w1[r], head[i1 * kHead + j])));
    }
    __syncthreads();
  }

  MARK(3);
  // ---- a row a warp: rebuild p, dL/dp, contract the columns (d_rows),
  // then the rows into the warp's partial dx8 ----
  int jc[kSpan];  // the head columns this lane touches (clamped)
#pragma unroll
  for (int m = 0; m < kSpan; ++m) jc[m] = jl + m < kHead ? jl + m : kHead - 1;
  const int jq = lane_column(lane);  // the head column whose d_rows this lane ends with
  float pw[kHead] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dx8[i][jq], its rows
  for (int r = warp; r < nrows; r += kWarps) {
    const int i0 = row_i0[r];
    const int i1 = i0 + 1 < kHead ? i0 + 1 : i0;
    const float u0 = row_w0[r], u1 = row_w1[r];
    float h0[kSpan], h1[kSpan];  // fp32: x[i0][jc], x[i1][jc]; bf16: rows[r][jc]
#pragma unroll
    for (int m = 0; m < kSpan; ++m) {
      h0[m] = sizeof(T) == 2 ? rows[r][jc[m]] : head[i0 * kHead + jc[m]];
      h1[m] = sizeof(T) == 2 ? 0.f : head[i1 * kHead + jc[m]];
    }
    const float* g = band + r * hw + cols * lane;
    float acc[kSpan] = {0.f, 0.f, 0.f};  // d_rows[r][jl + m], this lane's columns
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < cols) {
        const float a0 = e[k] ? h0[1] : h0[0], a1 = e[k] ? h0[2] : h0[1];
        float p;
        if (sizeof(T) == 2) {
          p = round_head<T>(__fadd_rn(__fmul_rn(v0[k], a0), __fmul_rn(v1[k], a1)));
        } else {  // ATen's upsample_bilinear2d order
          const float b0 = e[k] ? h1[1] : h1[0], b1 = e[k] ? h1[2] : h1[1];
          p = u0 * (v0[k] * a0 + v1[k] * a1) + u1 * (v0[k] * b0 + v1[k] * b1);
        }
        const float d = round_head<T>(c.a * (g[k] - c.gmean) - c.b * (p - c.mean));
        const float t0 = d * v0[k], t1 = d * v1[k];
        acc[0] += e[k] ? 0.f : t0;
        acc[1] += e[k] ? t0 : t1;
        acc[2] += e[k] ? t1 : 0.f;
      }
    }
    // d_rows[r][j] over the warp: a halving xor tree, 9 shuffles for the 8
    // sums; lane l ends with head column j = jq's, as do its 3 neighbours
    float v8[kHead];
#pragma unroll
    for (int j = 0; j < kHead; ++j) {
      const int m = j - jl;
      v8[j] = m == 0 ? acc[0] : (m == 1 ? acc[1] : (m == 2 ? acc[2] : 0.f));
    }
    const float d_row = round_head<T>(warp_sum_8(v8, lane));
#pragma unroll
    for (int i = 0; i < kHead; ++i) {  // w[i][r] is u0 at i0, u1 at i0 + 1
      pw[i] += i == i0 ? d_row * u0 : (i == i0 + 1 ? d_row * u1 : 0.f);
    }
  }
  MARK(4);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < kHead; ++i) warp_part[warp][i * kHead + jq] = pw[i];
  }
  __syncthreads();

  MARK(5);
  // ---- the block's partial dx8: the warps' in order ----
  float part = 0.f;  // thread t < 64: dx8[t / 8][t % 8]
  if (tid < kHead2) {
    part = warp_part[0][tid];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) part += warp_part[v][tid];
  }

  MARK(6);
  // ---- the item's C partials, in rank order ----
  T* dst = out + static_cast<long long>(item) * kHead2;
  if (tid < kHead2) {
    partial[(static_cast<long long>(item) * nblocks + rank) * kHead2 + tid] = part;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + item, 1u) == static_cast<unsigned>(nblocks - 1);
  __syncthreads();
  MARK(7);
  if (!last) return;
  __threadfence();
  if (tid < kHead2) {  // every block's partial loaded at once, summed in rank order
    const float* all = partial + static_cast<long long>(item) * nblocks * kHead2 + tid;
    float v[kMaxBlocks];
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r) v[r] = r < nblocks ? __ldcg(all + r * kHead2) : 0.f;
    float sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxBlocks; ++r) {
      if (r < nblocks) sum += v[r];
    }
    store_head(dst + tid, sum);
  }
  MARK(8);
  if (tid == 0) tickets[item] = 0u;  // ready for the next launch
}

template <typename T>
int launch(const void* x8, const void* gt, const void* stats, const void* upstream,
           const void* w, void* out, void* partial, void* tickets, int batch, int hw,
           int nss_r, int blocks, cudaStream_t stream) {
  auto kernel = head_grad_kernel<T>;
  const int band_rows = (hw + blocks - 1) / blocks;
  const size_t smem = static_cast<size_t>(band_rows + kHead) * hw * 4;  // band, w
  // the default limit is 48 KB of static and dynamic shared memory together:
  // opt in to this launch's size, once a device
  static size_t smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = smem;
  }
  kernel<<<dim3(blocks, batch, 1), kThreads, smem, stream>>>(
      static_cast<const T*>(x8), static_cast<const float*>(gt),
      static_cast<const float*>(stats), static_cast<const float*>(upstream),
      static_cast<const float*>(w), static_cast<T*>(out), static_cast<float*>(partial),
      static_cast<unsigned*>(tickets), hw, nss_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x8, out: (batch, 8, 8) float32 (bf16 = 0) or bfloat16 (bf16 = 1); gt:
// (batch, hw, hw) float32, 16-byte aligned, hw a multiple of 32 up to 256;
// stats: (batch, 8) rows of the forward kernel; upstream: (batch,)
// dL/d(-NSS); w: (8, hw) float32 resize weights; nss_r in {-1, 0, 1};
// blocks: bands an item, 8..32; partial: (batch, blocks, 64) float32
// scratch and tickets: (batch,) uint32, zero before the first launch and
// left zero by each. Returns the CUDA error code of the launch.
extern "C" int saliency_head_grad_launch(const void* x8, const void* gt, const void* stats,
                                         const void* upstream, const void* w, void* out,
                                         void* partial, void* tickets, int batch, int hw,
                                         int nss_r, int bf16, int blocks, void* stream) {
  if (batch <= 0) return 0;
  if (hw < 32 || hw > kMaxHW || hw % 32 != 0 || batch > 65535 || nss_r < -1 ||
      nss_r > 1 || blocks < kMinBlocks || blocks > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x8, gt, stats, upstream, w, out, partial, tickets,
                                      batch, hw, nss_r, blocks, s)
              : launch<float>(x8, gt, stats, upstream, w, out, partial, tickets, batch, hw,
                              nss_r, blocks, s);
}

#ifdef HEAD_GRAD_MARKS
// The marks of the blocks of the last launches: n = blocks * kMarkSlots.
extern "C" int saliency_head_grad_marks_read(void* host, long long n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_marks, n * sizeof(long long)));
}

extern "C" int saliency_head_grad_marks_clear(long long n) {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_marks);
  return static_cast<int>(err != cudaSuccess ? err : cudaMemset(p, 0, n * sizeof(long long)));
}
#endif
