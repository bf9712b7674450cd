// The teacher oracle for a batch of items in one launch, written by hand for
// Hopper (sm_90a): sim/oracle.py:teacher_action_batch_plain's three outputs
// per item,
//   progress       the hull-union IoU of the view against the final GT view
//                  (geometry/quad.py:quad_iou: two 4-point Jarvis hulls, the
//                  Sutherland-Hodgman clip of one by the other, the 8-point
//                  union hull, the shoelace areas);
//   altitude       the edge of the closest GT step, found by the descending
//                  scan with the 1e-5 strict-improvement epsilon;
//   waypoint_ratio the point where the goal line (student) or the GT
//                  polyline (teacher forcing, the goal line as its fallback)
//                  leaves the view (Liang-Barsky), the one closest to the
//                  goal, as a ratio of the view's int-rounded half-axes (a
//                  2x2 solve), clamped to the infinity-ball and zeroed by the
//                  stop mask (ended, or progress > 0.5).
//
// Replaces: no TPU kernel. In JAX this path is avdn_tpu/sim/oracle.py:
// teacher_action under vmap, which XLA fuses into a few kernels. The port's
// plain version writes it as Python loops over tensors of B rows: about 3,400
// ATen launches a call, each moving a few hundred bytes.
//
// Bound on this card: launch latency. An item reads its view (32 bytes), its
// flag, its GT path (32 bytes a step: 384 at max_gt_len 12) and its length,
// and writes 16 bytes: about 450 bytes, 2 ns for 16 items at 3.35 TB/s. Its
// few thousand dependent fp32 operations are a few microseconds of one
// thread. So one launch replaces the plain version's thousands, and the
// design only keeps the longest dependent chain short:
// - A block of three warps an item, one grid. Warp 0's lane 0 computes the
//   intersection area, warp 1's lane 0 the union hull's area, side by side;
//   warp 2 computes the altitude and the waypoint meanwhile: its lanes take
//   32 GT steps at a time (the closest-step distances, then the polyline's
//   segment clips), so max_gt_len is looped over, not capped. The closest-
//   step scan is order-dependent: it runs over the lanes' distances by
//   shuffle, in the plain version's descending order. The closest-to-goal
//   pick is a shuffle tree over (distance, index) pairs in torch.argmin's
//   order (NaN first, then the smaller, ties to the lower index), which is
//   a total order, so the tree gives the serial answer.
// - Small fixed-size arrays stay in registers: dynamic indices go through
//   select chains (pick, put).
//
// Exactness: the same bits as the plain version on the card (the benchmark's
// frozen reference runs that arithmetic, and progress > 0.5 decides when the
// teacher stops). Every operation is one rounding, as one ATen kernel rounds
// it: __fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn, never contracted (nvcc
// contracts a*b + c by default). geometry/transforms.py:fma is the float64
// product of two float32 values, a float64 add, then rounding to float32.
// ATen's reductions on the card add each element to a zero accumulator and
// combine the accumulators in index order: a 4-corner mean is
// (((0+a)+(0+b))+(0+c))+(0+d) times 1/4, a 2-element sum (0+a)+(0+b), and
// linalg.vector_norm squares each element into its own accumulator
// (sqrt(x*x + y*y), both squares rounded). A tensor divided by a Python
// scalar is multiplied by the float32 reciprocal on the card: altitude is
// (edge - 40) * fl(1/360). torch.round is nearbyintf; clamp and the value of
// min/max along a dimension follow ATen's NaN rules. tests/
// test_torch_oracle_card.py holds every output bit-equal to the plain version
// on the card.
//
// Plain C interface (loaded with ctypes): the launch returns the CUDA error
// of the launch so the wrapper can raise.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 3 * kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClipNv = 8;  // geometry/quad.py:_CLIP_NV

// The plain version's Python scalars as its float32 tensors see them (a
// double rounded to float32).
constexpr float kEps = static_cast<float>(1e-12);     // geometry/quad.py:_EPS
constexpr float kStepEps = static_cast<float>(1e-5);  // the closest-step scan
constexpr float kInv360 = 1.0f / 360.0f;              // 1 / (400 - 40)
constexpr float kDegToM = 111300.0f;                  // geometry/transforms.py:DEG_TO_M
constexpr float kInf = std::numeric_limits<float>::infinity();

struct P {
  float x, y;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// geometry/transforms.py:fma
__device__ __forceinline__ float fma_ref(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// torch.sum over two elements
__device__ __forceinline__ float sum2(float a, float b) {
  return add(add(0.f, a), add(0.f, b));
}

// Tensor.mean over four elements
__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
  return mul(add(add(add(add(0.f, a), add(0.f, b)), add(0.f, c)), add(0.f, d)), 0.25f);
}

// linalg.vector_norm of (x, y)
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(sum2(mul(x, x), mul(y, y)));
}

__device__ __forceinline__ float dist(P a, P b) { return norm2(sub(a.x, b.x), sub(a.y, b.y)); }

// torch.clamp(v, min=lo) / (v, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// (a, ia) comes before (b, ib) in torch.argmin's order (ATen's LessOrNan) /
// torch.argmax's (GreaterOrNan): NaN first, ties to the lower index.
__device__ __forceinline__ bool before_min(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a < b;
}
__device__ __forceinline__ bool before_max(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a > b;
}

template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = k == i ? a[k] : v;
  return v;
}

template <typename T, int N>
__device__ __forceinline__ void put(T (&a)[N], int i, T v) {
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = k == i ? v : a[k];
}

__device__ __forceinline__ P load(const float* p, int k) { return P{p[2 * k], p[2 * k + 1]}; }

// geometry/quad.py:_signed_area: the contracted shoelace terms added in order
template <int N>
__device__ float signed_area(const P (&v)[N]) {
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const P a = v[k], b = v[(k + 1) % N];
    const float term = fma_ref(a.x, b.y, -mul(b.x, a.y));
    total = k == 0 ? term : add(total, term);
  }
  return mul(total, 0.5f);
}

// geometry/quad.py:polygon_area: slots at and after count hold the first vertex
template <int N>
__device__ float polygon_area(const P (&v)[N], int count) {
  P d[N];
#pragma unroll
  for (int k = 0; k < N; ++k) d[k] = k < count ? v[k] : v[0];
  return fabsf(signed_area(d));
}

// One step of geometry/quad.py:convex_hull's Jarvis march from point cur.
template <int N>
__device__ int next_point(const P (&pts)[N], int cur, int start) {
  const P c = pick(pts, cur);
  float rx[N], ry[N], d2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    rx[k] = sub(pts[k].x, c.x);
    ry[k] = sub(pts[k].y, c.y);
    d2[k] = sum2(mul(rx[k], rx[k]), mul(ry[k], ry[k]));
  }
  int best0 = 0;  // the farthest point
  float far = d2[0];
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (before_max(d2[k], k, far, best0)) {
      far = d2[k];
      best0 = k;
    }
  }
  // the candidate's row kept in registers: no lookup in the chain
  int best = best0;
  float bx = pick(rx, best0), by = pick(ry, best0), bd = far;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float cr = sub(mul(bx, ry[r]), mul(by, rx[r]));
    if (cr < -kEps || (fabsf(cr) <= kEps && d2[r] > bd)) {
      best = r;
      bx = rx[r];
      by = ry[r];
      bd = d2[r];
    }
  }
  // degenerate: every point coincides with the current one
  return far <= kEps ? start : best;
}

// geometry/quad.py:convex_hull: the hull in hull[0, count), the rest of its
// slots the start point; returns count.
template <int N>
__device__ int convex_hull(const P (&pts)[N], P (&hull)[N]) {
  // start at the smallest x among the points of the smallest y
  float miny = pts[0].y;
  int imin = 0;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (before_min(pts[k].y, k, miny, imin)) {
      miny = pts[k].y;
      imin = k;
    }
  }
  int start = 0;
  float sx = pts[0].y <= miny ? pts[0].x : kInf;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float xk = pts[k].y <= miny ? pts[k].x : kInf;
    if (before_min(xk, k, sx, start)) {
      sx = xk;
      start = k;
    }
  }
  const P first = pts[start];
  int cur = start, count = 0;
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < N; ++it) {
    if (done) {
      put(hull, it, first);
      continue;
    }
    const int nxt = next_point(pts, cur, start);
    put(hull, it, pick(pts, cur));
    ++count;
    done = nxt == start;
    cur = nxt;
  }
  return count;
}

// Appends p at slot cnt % 8 when on (clip_convex's emit).
__device__ __forceinline__ void emit(P (&out)[kClipNv], int& cnt, bool on, P p) {
  const int slot = cnt % kClipNv;
#pragma unroll
  for (int s = 0; s < kClipNv; ++s) out[s] = (on && s == slot) ? p : out[s];
  cnt += on;
}

// geometry/quad.py:clip_convex: the subject's 8 slots clipped by the
// counter-clockwise, duplicate-padded 4-slot clip polygon; returns the count.
__device__ int clip_convex(P (&verts)[kClipNv], int count, const P (&clip)[4], int clip_count) {
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const P a = pick(clip, k);
    const int kb = (k + 1 < clip_count && k + 1 < 4) ? k + 1 : 0;
    const P b = pick(clip, kb);
    const float ex = sub(b.x, a.x), ey = sub(b.y, a.y);
    const bool degenerate = sum2(mul(ex, ex), mul(ey, ey)) <= kEps;  // a padded edge
    P out[kClipNv];
#pragma unroll
    for (int s = 0; s < kClipNv; ++s) out[s] = P{0.f, 0.f};
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kClipNv; ++i) {
      const bool valid = i < count;
      const P cur = verts[i];
      // the plain version would index past its 8 slots here; the kernel wraps
      const P nxt = (i + 1 < count && i + 1 < kClipNv) ? verts[(i + 1) % kClipNv] : verts[0];
      const float dcur = sub(mul(ex, sub(cur.y, a.y)), mul(ey, sub(cur.x, a.x)));
      const float dnxt = sub(mul(ex, sub(nxt.y, a.y)), mul(ey, sub(nxt.x, a.x)));
      const bool cur_in = dcur >= 0.f, nxt_in = dnxt >= 0.f;
      const float denom = sub(dcur, dnxt);
      const float t = fabsf(denom) > kEps ? quo(dcur, denom) : 0.f;
      const P inter{add(cur.x, mul(t, sub(nxt.x, cur.x))), add(cur.y, mul(t, sub(nxt.y, cur.y)))};
      emit(out, cnt, valid && cur_in, cur);
      emit(out, cnt, valid && (cur_in != nxt_in), inter);
    }
    if (!(degenerate || k >= clip_count)) {
#pragma unroll
      for (int s = 0; s < kClipNv; ++s) verts[s] = out[s];
      count = cnt;
    }
  }
  return count;
}

// The intersection area of quad_iou: hull(a) clipped by hull(b) made
// counter-clockwise (geometry/quad.py:_order_ccw_padded).
__device__ float intersection_area(const P (&a)[4], const P (&b)[4]) {
  P ha[4], hb[4];
  const int na = convex_hull(a, ha);
  const int nb = convex_hull(b, hb);
  P dp[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) dp[k] = k < nb ? hb[k] : hb[0];
  const bool cw = signed_area(dp) < 0.f;
  P ccw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ccw[k] = cw ? (k < nb ? pick(hb, nb - 1 - k) : hb[0]) : hb[k];
  P clip[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) clip[k] = k < nb ? ccw[k] : ccw[0];
  P verts[kClipNv];
#pragma unroll
  for (int k = 0; k < kClipNv; ++k) verts[k] = k < 4 ? ha[k] : P{0.f, 0.f};
  const int n = clip_convex(verts, na, clip, nb);
  return n >= 3 ? polygon_area(verts, n) : 0.f;
}

struct Seg {
  P q0, q1;
  bool valid;
};

// geometry/quad.py:clip_segment_to_quad against the counter-clockwise view q.
__device__ Seg clip_segment(P p0, P p1, const P (&q)[4]) {
  const float dx = sub(p1.x, p0.x), dy = sub(p1.y, p0.y);
  float lo = -kInf, hi = kInf;
  int ilo = 0, ihi = 0;
  bool infeasible = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const P a = q[k], b = q[(k + 1) % 4];
    const float nx = -sub(b.y, a.y), ny = sub(b.x, a.x);  // the inward normal
    const float num = sum2(mul(nx, sub(p0.x, a.x)), mul(ny, sub(p0.y, a.y)));
    const float den = sum2(mul(nx, dx), mul(ny, dy));
    const float lc = den > kEps ? quo(-num, den) : -kInf;
    const float hc = den < -kEps ? quo(-num, den) : kInf;
    infeasible = infeasible || (fabsf(den) <= kEps && num < 0.f);
    if (k == 0 || before_max(lc, k, lo, ilo)) {
      lo = lc;
      ilo = k;
    }
    if (k == 0 || before_min(hc, k, hi, ihi)) {
      hi = hc;
      ihi = k;
    }
  }
  const float t0 = clamp_min(lo, 0.f), t1 = clamp_max(hi, 1.f);
  return Seg{P{add(p0.x, mul(t0, dx)), add(p0.y, mul(t0, dy))},
             P{add(p0.x, mul(t1, dx)), add(p0.y, mul(t1, dy))}, t0 <= t1 && !infeasible};
}

// GT step j's center (gt_corners.mean(dim=2))
__device__ __forceinline__ P center(const float* g, int j) {
  const float* q = g + 8 * static_cast<long long>(j);
  return P{mean4(q[0], q[2], q[4], q[6]), mean4(q[1], q[3], q[5], q[7])};
}

struct Cand {
  float d;
  int i;
  P p;
};

__device__ __forceinline__ Cand first_min(Cand a, Cand b) {
  return before_min(b.d, b.i, a.d, a.i) ? b : a;
}

__global__ void __launch_bounds__(kThreads)
teacher_oracle_kernel(const float* __restrict__ corners, const unsigned char* __restrict__ ended,
                      const float* __restrict__ gt_corners, const long long* __restrict__ gt_len,
                      float* __restrict__ out, int batch, int max_t, int teacher_forcing) {
  __shared__ float areas[2];  // intersection, union hull
  const int item = blockIdx.x;
  const float* c = corners + 8 * static_cast<long long>(item);
  const float* g = gt_corners + 8 * static_cast<long long>(max_t) * item;
  const long long len = gt_len[item];
  const int goal = static_cast<int>(len - 1 < 0 ? 0 : (len - 1 < max_t ? len - 1 : max_t - 1));
  const float* gq = g + 8 * goal;

  if (threadIdx.x == 0 || threadIdx.x == kWarp) {
    P a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = load(c, k);
      b[k] = load(gq, k);
    }
    if (threadIdx.x == 0) {
      areas[0] = intersection_area(a, b);
    } else {
      P pts[8], hull[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pts[k] = a[k];
        pts[4 + k] = b[k];
      }
      areas[1] = polygon_area(hull, convex_hull(pts, hull));
    }
  }

  // warp 2: altitude and waypoint (every lane keeps the scan's state)
  const int lane = threadIdx.x % kWarp;
  P cur{0.f, 0.f}, way{0.f, 0.f}, view[4];
  float altitude = 0.f;
  if (threadIdx.x >= 2 * kWarp) {
#pragma unroll
    for (int k = 0; k < 4; ++k) view[k] = load(c, k);
    cur = P{mean4(view[0].x, view[1].x, view[2].x, view[3].x),
            mean4(view[0].y, view[1].y, view[2].y, view[3].y)};
    const P goal_c{mean4(gq[0], gq[2], gq[4], gq[6]), mean4(gq[1], gq[3], gq[5], gq[7])};

    // the closest GT step, scanning down from the last
    float min_dis = 1000.f;
    int closest = 0;
    for (int base = max_t - 1; base >= 0; base -= kWarp) {
      const int j = base - lane;
      const float d = j >= 0 ? dist(center(g, j), cur) : 0.f;
      const int n = base + 1 < kWarp ? base + 1 : kWarp;
      for (int l = 0; l < n; ++l) {
        const float dl = __shfl_sync(kFull, d, l);
        if (base - l < len && add(dl, kStepEps) < min_dis) {
          min_dis = dl;
          closest = base - l;
        }
      }
    }
    const float* cq = g + 8 * closest;
    altitude = mul(sub(mul(norm2(sub(cq[0], cq[2]), sub(cq[1], cq[3])), kDegToM), 40.f), kInv360);

    // the view counter-clockwise (geometry/quad.py:orient_ccw)
    P ccw[4];
    const bool cw = signed_area(view) < 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) ccw[k] = cw ? view[3 - k] : view[k];

    Cand best{kInf, 0x7fffffff, P{0.f, 0.f}};
    bool any_poly = false;
    if (teacher_forcing) {
      // the GT polyline's segments, 32 at a time; candidate s is segment s's
      // entry point, candidate s + nseg its exit point
      const int nseg = max_t - 1;
      for (int base = 0; base < nseg; base += kWarp) {
        const int s = base + lane;
        Cand mine{kInf, 0x7fffffff, P{0.f, 0.f}};
        bool v = false;
        if (s < nseg) {
          const Seg sg = clip_segment(center(g, s), center(g, s + 1), ccw);
          v = sg.valid && s < len - 1;
          mine = first_min(Cand{v ? dist(sg.q0, goal_c) : kInf, s, sg.q0},
                           Cand{v ? dist(sg.q1, goal_c) : kInf, s + nseg, sg.q1});
        }
        any_poly = any_poly || __any_sync(kFull, v);
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2) {
          const Cand o{__shfl_xor_sync(kFull, mine.d, off), __shfl_xor_sync(kFull, mine.i, off),
                       P{__shfl_xor_sync(kFull, mine.p.x, off),
                         __shfl_xor_sync(kFull, mine.p.y, off)}};
          mine = first_min(mine, o);
        }
        best = first_min(best, mine);
      }
    }
    if (!any_poly) {
      // the goal line: the student's target, and the polyline's fallback
      const Seg line = clip_segment(cur, goal_c, ccw);
      best = first_min(Cand{line.valid ? dist(line.q0, goal_c) : kInf, 0, line.q0},
                       Cand{line.valid ? dist(line.q1, goal_c) : kInf, 1, line.q1});
    }
    if (best.d < 1.f) way = best.p;
  }
  __syncthreads();
  if (threadIdx.x != 2 * kWarp) return;

  const float inter = areas[0], uni = areas[1];
  float progress = uni > 0.f ? quo(inter, clamp_min(uni, kEps)) : 0.f;
  progress = isnan(progress) ? progress : fminf(fmaxf(progress, 0.f), 1.f);

  // the waypoint in the view's frame (agent.py:484-503)
  const P nn{mul(sub(way.x, cur.x), 1e5f), mul(sub(way.y, cur.y), 1e5f)};
  const P ny{nearbyintf(mul(sub(mul(add(view[0].x, view[1].x), 0.5f), cur.x), 1e5f)),
             nearbyintf(mul(sub(mul(add(view[0].y, view[1].y), 0.5f), cur.y), 1e5f))};
  const P nx{nearbyintf(mul(sub(mul(add(view[1].x, view[2].x), 0.5f), cur.x), 1e5f)),
             nearbyintf(mul(sub(mul(add(view[1].y, view[2].y), 0.5f), cur.y), 1e5f))};
  const float det = sub(mul(nx.x, ny.y), mul(ny.x, nx.y));
  const float safe = fabsf(det) > kEps ? det : 1.f;
  float r0 = quo(sub(mul(nn.x, ny.y), mul(ny.x, nn.y)), safe);
  float r1 = quo(sub(mul(nx.x, nn.y), mul(nn.x, nx.y)), safe);
  const float a0 = fabsf(r0), a1 = fabsf(r1);
  const float m = clamp_min(before_max(a1, 1, a0, 0) ? a1 : a0, 1.f);
  r0 = quo(r0, m);
  r1 = quo(r1, m);
  if (ended[item] || progress > 0.5f) r0 = r1 = 0.f;

  out[2 * item] = r0;
  out[2 * item + 1] = r1;
  out[2 * batch + item] = altitude;
  out[3 * batch + item] = progress;
}

}  // namespace

// corners (batch, 4, 2) float32, ended (batch,) bool, gt_corners (batch,
// max_t, 4, 2) float32, gt_len (batch,) int64, all contiguous. out: 4*batch
// float32, the waypoint ratios (batch, 2), then the altitudes, then the
// progress. teacher_forcing needs max_t >= 2. Returns the CUDA error code of
// the launch.
extern "C" int teacher_oracle_launch(const void* corners, const void* ended,
                                     const void* gt_corners, const void* gt_len, void* out,
                                     int batch, int max_t, int teacher_forcing, void* stream) {
  if (batch < 1 || max_t < (teacher_forcing ? 2 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  teacher_oracle_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners), static_cast<const unsigned char*>(ended),
      static_cast<const float*>(gt_corners), static_cast<const long long*>(gt_len),
      static_cast<float*>(out), batch, max_t, teacher_forcing);
  return static_cast<int>(cudaGetLastError());
}
