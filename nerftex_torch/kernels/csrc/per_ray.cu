// The per-ray stage of the device instancer for one ray block, for Hopper
// (sm_90a): the block's ray fan and cull keep sets, then each ray's mesh
// first hit, slab intervals, top-K nearest intervals and their union as
// sorted events with prefix sums, and the per-ray sample layout.
//
// Replaces: no Pallas kernel.  It replaces the eager chain of
// nerftex_tpu/instancing/device.py's _per_ray (the fan, the culls' keep sets
// and branches, Moller-Trumbore, the slab test, lax.top_k, the event sort
// and cumsums), which XLA fuses on the TPU and which PyTorch ran as about 300
// launches and three host reads a ray block (kernels/per_ray.py
// per_ray_plain, the chain as it was).
//
// What bounds it on the H100: neither bytes nor operations.  A block is
// 1,024-2,048 rays against 448-10,000 boxes and 384-5,000 triangles (a few
// hundred million float operations at most, a few MB of tables), so the card
// is done in tens of microseconds; the chain it replaces spent 4-7 ms a block
// of host time issuing launches and waiting on three reads.  What the design
// does about that: two launches and a memset a block, no host read.
//  - fan_cull_kernel, one CTA: the fan of geometry.block_fan (origin sphere,
//    mean direction, power-iterated in-fan axis, fan normal, sine and angle
//    bounds) reduced over the block's rays, then the geometry.fan_keep test
//    of every instance and triangle sphere (the instance spheres widened by
//    what bfloat16 slab operands can reach, geometry.slab_pad), each keep
//    set compacted in ascending id order with its count (a block-wide ballot
//    scan).  Whether a set fits its
//    budget is read by the next kernel from the count: the branch is chosen
//    on the card.  The fan is conservative by construction, as the chain's
//    is, so either branch gives the same tables.
//  - per_ray_kernel, a warp a ray, kWarps rays a CTA: columns (triangles,
//    then boxes; the candidates where the set fits, else every column) are
//    staged in shared memory kThreads at a time and each lane tests one
//    column.  The first hit keeps the smallest t and the first column on
//    ties (a warp argmin).  Valid intervals are merged into the ray's sorted
//    list of K (t0c, t1c, column) in shared memory: each batch of up to 32 by
//    rank (ties to the earlier column, as the stable sort breaks them), and
//    once the list is full, a batch whose t0c is not below its last entry is
//    only counted.  The 2n events of the n kept intervals are merged by rank
//    (starts before ends at equal t, then slot order, as the stable sort
//    orders cat([tk0, tk1])) and walked by one lane, its sums in double and
//    each output rounded once, as PyTorch's CPU cumsum does; the rest of the
//    2K slots are the constants that the chain's padding gives.
//  - K comes from the tables' shape; kCap (32, 64, 128) sizes the lists, and
//    the wrapper refuses a K above the largest.
//
// Rounding: the triangle test and the slab arithmetic are separately rounded
// intrinsics in the chain's order, with its constants and its correctly
// rounded reciprocals; the ray-to-local products and the anchor terms
// sel_a, sel_b are fma(a2, b2, fma(a1, b1, a0 b0)), the contraction of a
// 3-term dot (the product with operands rounded to bfloat16 when asked, as
// round_operand does); n_steps is floor(total / step), correctly rounded as
// PyTorch divides.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFanThreads = 1024;
constexpr int kWarps = 4;                 // rays a CTA
constexpr int kThreads = 32 * kWarps;     // columns a tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTFar = (float)100.0;     // T_FAR
constexpr float kEps = (float)1e-12;      // |det|, |d_l| floor and the fan's norm floor
constexpr float kTMin = (float)1e-6;      // a triangle hit's least t
constexpr float kFanPad = (float)1e-6;    // the fan's sine and angle pads
constexpr float kHalfPi = (float)(3.141592653589793 / 2);

// The cull buffer: counts of the instance and triangle keep sets, the
// culls that fit and did not, then the kept ids.
enum { kCountInst = 0, kCountTri = 1, kFit = 2, kOver = 3, kMeta = 4 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (a0 b0 + a1 b1) + a2 b2, each operation rounded on its own.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// fma(a2, b2, fma(a1, b1, a0 b0)).
__device__ __forceinline__ float dot3_fma(float a0, float a1, float a2, float b0, float b1,
                                          float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}

// To bfloat16 and back, to nearest even.
__device__ __forceinline__ float round_bf16(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// the fan and the keep sets (one CTA)
// ---------------------------------------------------------------------------

struct Fan {
  float oc[3], oc_n, r_o, u[3], w[3], nrm[3], sin_perp, s_in;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int s = 16; s; s >>= 1) x += __shfl_xor_sync(kFull, x, s);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int s = 16; s; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, s));
  return x;
}

// Sums (kMax false) or maxima of v[0 .. N) over the CTA; every thread gets
// them.  red holds 32 * N floats.
template <int N, bool kMax>
__device__ void block_reduce(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = kMax ? warp_max(v[i]) : warp_sum(v[i]);
    if (lane == 0) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = red[i];
    for (int w = 1; w < n_warps; ++w) acc = kMax ? fmaxf(acc, red[w * N + i]) : acc + red[w * N + i];
    v[i] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float norm3(const float* a) {
  return sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
}

// A ray's direction (components col floats apart) over its norm (floored
// at kEps).
__device__ __forceinline__ void unit_dir(const float* d, int col, float* dn) {
  const float x = d[0], y = d[col], z = d[2 * col];
  const float s = fmaxf(sqrtf(x * x + y * y + z * z), kEps);
  dn[0] = x / s;
  dn[1] = y / s;
  dn[2] = z / s;
}

// geometry.fan_keep: true for every sphere that can meet a ray of the fan,
// each sphere first widened by pa (|c| + radius) + pb (|oc| + dist + 2 r_o +
// radius), the pad that holds every box a slab test over rounded operands
// can hit (geometry.slab_pad; 0 at float32 and for triangles).
__device__ __forceinline__ bool fan_keep(const Fan& f, const float* c, float radius, float pa,
                                         float pb) {
  const float v[3] = {c[0] - f.oc[0], c[1] - f.oc[1], c[2] - f.oc[2]};
  const float dist = norm3(v);
  if (pa != 0.f || pb != 0.f) {
    radius = radius + (pa * (norm3(c) + radius) + pb * (f.oc_n + dist + 2.f * f.r_o + radius));
  }
  const float reach = radius + f.r_o;
  if (dist <= reach) return true;
  const float vn = v[0] * f.nrm[0] + v[1] * f.nrm[1] + v[2] * f.nrm[2];
  if (!(fabsf(vn) <= (dist + reach) * f.sin_perp + reach)) return false;
  const float va = v[0] * f.u[0] + v[1] * f.u[1] + v[2] * f.u[2];
  const float vb = v[0] * f.w[0] + v[1] * f.w[1] + v[2] * f.w[2];
  const float theta = atan2f(fabsf(vb), va);
  if (theta <= f.s_in) return true;
  const float dtheta = fminf(fmaxf(theta - f.s_in, 0.f), kHalfPi);
  return sqrtf(va * va + vb * vb) * sinf(dtheta) <= reach;
}

// The ids of the kept spheres in ascending order into cand[0 .. budget),
// and their count (counting stops once it passes the budget: the set does
// not fit, and the ids are not read).
__device__ int compact(const Fan& f, const float* center, const float* radius, int n,
                       int budget, float pa, float pb, int* cand, int* warp_counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int total = 0;
  for (int base = 0; base < n && total <= budget; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool keep = i < n && fan_keep(f, center + 3 * i, radius[i], pa, pb);
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u)), chunk = 0;
    for (int w = 0; w < n_warps; ++w) {
      before += w < warp ? warp_counts[w] : 0;
      chunk += warp_counts[w];
    }
    if (keep && total + before < budget) cand[total + before] = i;
    total += chunk;
    __syncthreads();
  }
  return total;
}

struct Spheres {
  const float* center;  // [n, 3]
  const float* radius;  // [n]
  int n;
  int budget;           // 0: this kind is not culled
  float pa, pb;         // the spheres' pad coefficients (fan_keep)
  int* cand;            // [budget]
};

__global__ void __launch_bounds__(kFanThreads)
fan_cull_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d, int o_row,
                int o_col, int d_row, int d_col, int rb, Spheres inst, Spheres tri,
                int* __restrict__ meta) {
  __shared__ float red[32 * 6];
  __shared__ int warp_counts[32];
  __shared__ Fan fan;
  const float inv_rb = 1.f / (float)rb;

  // The origins' centre and the mean unit direction.
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < rb; i += blockDim.x) {
    const float* o = rays_o + (size_t)i * o_row;
    float dn[3];
    unit_dir(rays_d + (size_t)i * d_row, d_col, dn);
    for (int c = 0; c < 3; ++c) {
      s[c] += o[c * o_col];
      s[3 + c] += dn[c];
    }
  }
  block_reduce<6, false>(s, red);
  float oc[3], u[3];
  for (int c = 0; c < 3; ++c) {
    oc[c] = s[c] * inv_rb;
    u[c] = s[3 + c] * inv_rb;
  }
  const float un = fmaxf(norm3(u), kEps);
  for (int c = 0; c < 3; ++c) u[c] /= un;

  // The origin sphere's radius and the covariance of the directions' parts
  // across u.
  float r2[1] = {0.f};
  float cov[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // xx, xy, xz, yy, yz, zz
  for (int i = threadIdx.x; i < rb; i += blockDim.x) {
    const float* o = rays_o + (size_t)i * o_row;
    const float v[3] = {o[0] - oc[0], o[o_col] - oc[1], o[2 * o_col] - oc[2]};
    r2[0] = fmaxf(r2[0], v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    float dn[3];
    unit_dir(rays_d + (size_t)i * d_row, d_col, dn);
    const float p = dn[0] * u[0] + dn[1] * u[1] + dn[2] * u[2];
    const float r[3] = {dn[0] - p * u[0], dn[1] - p * u[1], dn[2] - p * u[2]};
    cov[0] += r[0] * r[0];
    cov[1] += r[0] * r[1];
    cov[2] += r[0] * r[2];
    cov[3] += r[1] * r[1];
    cov[4] += r[1] * r[2];
    cov[5] += r[2] * r[2];
  }
  block_reduce<1, true>(r2, red);
  block_reduce<6, false>(cov, red);

  if (threadIdx.x == 0) {
    // The principal in-fan axis by three power iterations from the
    // covariance's column of largest diagonal, then the fan normal.
    const float m[3][3] = {{cov[0], cov[1], cov[2]}, {cov[1], cov[3], cov[4]},
                           {cov[2], cov[4], cov[5]}};
    int k = 0;
    for (int c = 1; c < 3; ++c) k = m[c][c] > m[k][k] ? c : k;
    float w[3] = {m[0][k] + 1e-20f, m[1][k] + 1e-20f, m[2][k] + 1e-20f};
    for (int it = 0; it < 3; ++it) {
      float x[3];
      for (int r = 0; r < 3; ++r) x[r] = m[r][0] * w[0] + m[r][1] * w[1] + m[r][2] * w[2];
      const float xn = fmaxf(norm3(x), kEps);
      for (int r = 0; r < 3; ++r) w[r] = x[r] / xn;
    }
    const float wu = w[0] * u[0] + w[1] * u[1] + w[2] * u[2];
    for (int r = 0; r < 3; ++r) w[r] -= wu * u[r];
    const float wn = fmaxf(norm3(w), kEps);
    for (int r = 0; r < 3; ++r) w[r] /= wn;
    float nrm[3] = {u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                    u[0] * w[1] - u[1] * w[0]};
    const float nn = fmaxf(norm3(nrm), kEps);
    for (int r = 0; r < 3; ++r) {
      fan.oc[r] = oc[r];
      fan.u[r] = u[r];
      fan.w[r] = w[r];
      fan.nrm[r] = nrm[r] / nn;
    }
    fan.oc_n = norm3(oc);
    fan.r_o = sqrtf(fmaxf(r2[0], 0.f));
  }
  __syncthreads();

  // The out-of-plane sine and in-plane angle bounds.
  float b[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < rb; i += blockDim.x) {
    float dn[3];
    unit_dir(rays_d + (size_t)i * d_row, d_col, dn);
    b[0] = fmaxf(b[0], fabsf(dn[0] * fan.nrm[0] + dn[1] * fan.nrm[1] + dn[2] * fan.nrm[2]));
    b[1] = fmaxf(b[1], atan2f(fabsf(dn[0] * fan.w[0] + dn[1] * fan.w[1] + dn[2] * fan.w[2]),
                              dn[0] * fan.u[0] + dn[1] * fan.u[1] + dn[2] * fan.u[2]));
  }
  block_reduce<2, true>(b, red);
  Fan f = fan;
  f.sin_perp = b[0] + kFanPad;
  f.s_in = b[1] + kFanPad;

  const int n_inst = inst.budget ? compact(f, inst.center, inst.radius, inst.n, inst.budget,
                                           inst.pa, inst.pb, inst.cand, warp_counts) : 0;
  const int n_tri = tri.budget ? compact(f, tri.center, tri.radius, tri.n, tri.budget, tri.pa,
                                         tri.pb, tri.cand, warp_counts) : 0;
  if (threadIdx.x == 0) {
    const bool on_i = inst.budget > 0, on_t = tri.budget > 0;
    const int fit = (on_i && n_inst <= inst.budget) + (on_t && n_tri <= tri.budget);
    meta[kCountInst] = n_inst;
    meta[kCountTri] = n_tri;
    meta[kFit] = fit;
    meta[kOver] = (int)on_i + (int)on_t - fit;
  }
}

// ---------------------------------------------------------------------------
// the per-ray pass (a warp a ray)
// ---------------------------------------------------------------------------

// The columns a ray walks: every column (ids null), or the budget's
// positions, of which the first count hold the kept ids and the rest are
// padding that never hits.
struct Columns {
  const int* ids;
  int count;
  int n;
  __device__ int id(int j) const { return ids ? (j < count ? ids[j] : -1) : j; }
};

__device__ __forceinline__ Columns columns(const int* meta, int which, const int* cand,
                                           int budget, int n_all) {
  if (meta && budget > 0) {
    const int count = meta[which];
    if (count <= budget) return {cand, count, budget};
  }
  return {nullptr, n_all, n_all};
}

struct Inputs {
  const float *rays_o, *rays_d, *u_off;
  int o_row, o_col, d_row, d_col;              // the rays' strides (floats)
  int rb;
  const float *inv_rot, *inv_trans, *origins;  // [N, 3, 3], [N, 3], [N, 3]
  int n_inst;
  const float *v0, *e1, *e2;                   // [T, 3] each
  int n_tri;
  const float *b_0, *b_1;                      // [3] each
  const int* meta;                             // the cull buffer, or null without culls
  int budget_inst, budget_tri;                 // 0 where that kind is not culled
  int k, s;
  float step;
  int bf16;
};

// The outputs, in the layouts of kernels/per_ray.py (see nt_per_ray).
struct Outputs {
  float *tk0, *tk1, *sel_a, *sel_b;                 // [rb, k]
  float *times, *cum_incl, *cum_excl, *arc_corr;    // [rb, 2k]
  float *total, *t_offset, *t_mesh, *tri_u, *tri_v, *alpha_last;  // [rb]
  float* color_last;                                // [rb, 3]
  int64_t *inst_idx, *tri;                          // [rb, k], [rb]
  unsigned long long* overflow;                     // [2]: hits, steps
  int* n_steps;                                     // [rb]
  bool *kvalid, *tiny, *hit;                        // [rb, k], [rb], [rb]
};

// Moller-Trumbore of the ray (o, d) against tile column c ({v0, e1x},
// {e1y, e1z, e2x, e2y}, {e2z, -, -, -}): geometry.moller_trumbore's
// operations in its order; false where that gives t = inf.
__device__ __forceinline__ bool ray_hits_tri(const float4* c, const float* o, const float* d,
                                             float& t, float& u, float& v) {
  const float4 a = c[0], b = c[1];
  const float e1x = a.w, e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w, e2z = c[2].x;
  const float px = sub(mul(d[1], e2z), mul(d[2], e2y));
  const float py = sub(mul(d[2], e2x), mul(d[0], e2z));
  const float pz = sub(mul(d[0], e2y), mul(d[1], e2x));
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  if (!(fabsf(det) > kEps)) return false;
  const float inv_det = __frcp_rn(det);
  const float tx = sub(o[0], a.x), ty = sub(o[1], a.y), tz = sub(o[2], a.z);
  u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  if (!(u >= 0.f)) return false;
  const float qx = sub(mul(ty, e1z), mul(tz, e1y));
  const float qy = sub(mul(tz, e1x), mul(tx, e1z));
  const float qz = sub(mul(tx, e1y), mul(ty, e1x));
  v = mul(dot3(d[0], d[1], d[2], qx, qy, qz), inv_det);
  if (!(v >= 0.f && add(u, v) <= 1.f)) return false;
  t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
  return t > kTMin && t < kTFar;
}

// The slab test of the (rounded) ray against tile column c (rows {R_c,
// T_c}): the interval [t0, t1] before clipping.
__device__ __forceinline__ void slab(const float4* c, const float* o, const float* d,
                                     const float* b0, const float* b1, float& t0, float& t1) {
  t0 = -INFINITY;
  t1 = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 r = c[a];
    const float o_l = add(dot3_fma(o[0], o[1], o[2], r.x, r.y, r.z), r.w);
    const float d_l = dot3_fma(d[0], d[1], d[2], r.x, r.y, r.z);
    const float inv = __frcp_rn(fabsf(d_l) < kEps ? kEps : d_l);
    const float ta = mul(sub(b0[a], o_l), inv);
    const float tb = mul(sub(b1[a], o_l), inv);
    t0 = fmaxf(t0, fminf(ta, tb));
    t1 = fminf(t1, fmaxf(ta, tb));
  }
}

// Number of the first n entries of the ascending a that are below x (kLe
// false) or at most x (kLe true).
template <bool kLe>
__device__ __forceinline__ int rank_in(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kLe ? a[mid] <= x : a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The warp's sorted list of at most k intervals (by t0, then column).
template <int kCap>
struct List {
  float* t0;
  float* t1;
  int* col;
  int n;        // entries held
  int seen;     // valid intervals met
};

// Merge this lane's interval (if valid) into the list: the lanes' columns
// are above every column in the list and ascend with the lane.
template <int kCap>
__device__ __forceinline__ void merge(List<kCap>& l, int k, bool valid, float t0, float t1,
                                      int col) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(kFull, valid);
  if (!m) return;
  l.seen += __popc(m);
  if (l.n == k) {  // full: only intervals below the last entry get in
    valid = valid && t0 < l.t0[k - 1];
    m = __ballot_sync(kFull, valid);
    if (!m) return;
  }
  int pos = rank_in<true>(l.t0, l.n, t0);
  constexpr int kPer = kCap / 32;
  float e0[kPer], e1[kPer];
  int ec[kPer], shift[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    shift[q] = 0;
    e0[q] = e1[q] = 0.f;
    ec[q] = 0;
    if (i < l.n) {
      e0[q] = l.t0[i];
      e1[q] = l.t1[i];
      ec[q] = l.col[i];
    }
  }
  for (unsigned mm = m; mm; mm &= mm - 1u) {
    const int j = __ffs(mm) - 1;
    const float tj = __shfl_sync(kFull, t0, j);
    pos += tj < t0 || (tj == t0 && j < lane);
#pragma unroll
    for (int q = 0; q < kPer; ++q) shift[q] += tj < e0[q];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    if (i < l.n && i + shift[q] < k) {
      l.t0[i + shift[q]] = e0[q];
      l.t1[i + shift[q]] = e1[q];
      l.col[i + shift[q]] = ec[q];
    }
  }
  if (valid && pos < k) {
    l.t0[pos] = t0;
    l.t1[pos] = t1;
    l.col[pos] = col;
  }
  __syncwarp();
  l.n = min(l.n + __popc(m), k);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads) per_ray_kernel(Inputs in, Outputs out) {
  __shared__ float4 tile[3 * kThreads];
  __shared__ int tile_id[kThreads];
  __shared__ float s_t0[kWarps][kCap], s_t1[kWarps][kCap];
  __shared__ int s_col[kWarps][kCap];
  __shared__ float s_ev[kWarps][2 * kCap], s_cum[kWarps][2 * kCap], s_seg[kWarps][2 * kCap];
  __shared__ signed char s_delta[kWarps][2 * kCap];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  const bool live = r < in.rb;  // the whole warp
  const int rr = live ? r : 0;
  const int k = in.k;
  const float* ro = in.rays_o + (size_t)rr * in.o_row;
  const float* rd = in.rays_d + (size_t)rr * in.d_row;
  const float o[3] = {ro[0], ro[in.o_col], ro[2 * in.o_col]};
  const float d[3] = {rd[0], rd[in.d_col], rd[2 * in.d_col]};
  const int* cand_i = in.meta ? in.meta + kMeta : nullptr;
  const int* cand_t = cand_i ? cand_i + in.budget_inst : nullptr;
  const Columns tris = columns(in.meta, kCountTri, cand_t, in.budget_tri, in.n_tri);
  const Columns boxes = columns(in.meta, kCountInst, cand_i, in.budget_inst, in.n_inst);

  // 1. The mesh's first hit: the smallest t, the first column on ties.
  float best_t = INFINITY, best_u = 0.f, best_v = 0.f;
  int best_j = 0x7fffffff;
  for (int base = 0; base < tris.n; base += kThreads) {
    __syncthreads();
    if (base + (int)threadIdx.x < tris.n) {
      const int id = tris.id(base + threadIdx.x);
      tile_id[threadIdx.x] = id;
      if (id >= 0) {
        const float* a = in.v0 + 3 * (size_t)id;
        const float* b = in.e1 + 3 * (size_t)id;
        const float* c = in.e2 + 3 * (size_t)id;
        tile[3 * threadIdx.x] = make_float4(a[0], a[1], a[2], b[0]);
        tile[3 * threadIdx.x + 1] = make_float4(b[1], b[2], c[0], c[1]);
        tile[3 * threadIdx.x + 2] = make_float4(c[2], 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();
    if (live) {
      const int count = min(kThreads, tris.n - base);
      for (int j = lane; j < count; j += 32) {
        float t, u, v;
        if (tile_id[j] >= 0 && ray_hits_tri(tile + 3 * j, o, d, t, u, v) && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_j = base + j;
        }
      }
    }
  }
  for (int s = 16; s; s >>= 1) {
    const float t = __shfl_xor_sync(kFull, best_t, s);
    const int j = __shfl_xor_sync(kFull, best_j, s);
    const float u = __shfl_xor_sync(kFull, best_u, s);
    const float v = __shfl_xor_sync(kFull, best_v, s);
    if (t < best_t || (t == best_t && j < best_j)) {
      best_t = t;
      best_j = j;
      best_u = u;
      best_v = v;
    }
  }
  const bool mesh_hit = best_t < INFINITY;
  const float t_mesh = best_t;

  // 2. Slab intervals against the boxes, the K nearest kept.
  const float b0[3] = {in.b_0[0], in.b_0[1], in.b_0[2]};
  const float b1[3] = {in.b_1[0], in.b_1[1], in.b_1[2]};
  float o_r[3], d_r[3];
  for (int c = 0; c < 3; ++c) {
    o_r[c] = in.bf16 ? round_bf16(o[c]) : o[c];
    d_r[c] = in.bf16 ? round_bf16(d[c]) : d[c];
  }
  List<kCap> list = {s_t0[warp], s_t1[warp], s_col[warp], 0, 0};
  bool any_box = false;
  for (int base = 0; base < boxes.n; base += kThreads) {
    __syncthreads();
    if (base + (int)threadIdx.x < boxes.n) {
      const int id = boxes.id(base + threadIdx.x);
      tile_id[threadIdx.x] = id;
      if (id >= 0) {
        const float* rot = in.inv_rot + 9 * (size_t)id;
        const float* tr = in.inv_trans + 3 * (size_t)id;
        for (int a = 0; a < 3; ++a) {
          float x = rot[3 * a], y = rot[3 * a + 1], z = rot[3 * a + 2];
          if (in.bf16) {
            x = round_bf16(x);
            y = round_bf16(y);
            z = round_bf16(z);
          }
          tile[3 * threadIdx.x + a] = make_float4(x, y, z, tr[a]);
        }
      }
    }
    __syncthreads();
    if (live) {
      const int count = min(kThreads, boxes.n - base);
      for (int j0 = 0; j0 < count; j0 += 32) {
        const int j = j0 + lane;
        bool valid = false;
        float t0c = 0.f, t1c = 0.f;
        if (j < count && tile_id[j] >= 0) {
          float t0, t1;
          slab(tile + 3 * j, o_r, d_r, b0, b1, t0, t1);
          const bool box_hit = t0 < t1 && t1 > 0.f && t0 < kTFar;
          any_box |= box_hit;
          t0c = fminf(fmaxf(t0, 0.f), kTFar);
          t1c = fminf(fminf(fmaxf(t1, 0.f), kTFar), t_mesh);
          valid = box_hit && t0c < t1c;
        }
        merge<kCap>(list, k, valid, t0c, t1c, base + j);
      }
    }
  }
  if (!live) return;  // no barrier below
  any_box = __any_sync(kFull, any_box);
  const int n = list.n;

  // 3. The K slots: the kept intervals, then padding (instance 0).
  const size_t row = (size_t)r * k;
  for (int s = lane; s < k; s += 32) {
    float a = INFINITY, b = INFINITY;
    int id = 0;
    if (s < n) {
      a = list.t0[s];
      b = list.t1[s];
      id = boxes.id(list.col[s]);
    }
    const float* c = in.origins + 3 * (size_t)id;
    const float df0 = sub(o[0], c[0]), df1 = sub(o[1], c[1]), df2 = sub(o[2], c[2]);
    out.tk0[row + s] = a;
    out.tk1[row + s] = b;
    out.kvalid[row + s] = s < n;
    out.inst_idx[row + s] = id;
    out.sel_a[row + s] = dot3_fma(df0, df1, df2, df0, df1, df2);
    out.sel_b[row + s] = dot3_fma(d[0], d[1], d[2], df0, df1, df2);
  }
  __syncwarp();

  // 4. The union of the intervals: 2n events, starts before ends at equal t.
  float* ends = s_cum[warp];
  for (int i = lane; i < n; i += 32) {
    const float t = list.t1[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += list.t1[j] < t || (list.t1[j] == t && j < i);
    ends[rank] = t;
  }
  __syncwarp();
  float* ev = s_ev[warp];
  signed char* delta = s_delta[warp];
  for (int i = lane; i < n; i += 32) {
    const float ts = list.t0[i];
    const int ps = i + rank_in<false>(ends, n, ts);
    ev[ps] = ts;
    delta[ps] = 1;
    const float te = ends[i];
    const int pe = i + rank_in<true>(list.t0, n, te);
    ev[pe] = te;
    delta[pe] = -1;
  }
  __syncwarp();
  float* cum = s_cum[warp];
  float* seg = s_seg[warp];
  if (lane == 0) {
    int inside = 0;
    double acc = 0.0;
    for (int e = 0; e < 2 * n; ++e) {
      inside += delta[e];
      const float gap = e + 1 < 2 * n ? sub(ev[e + 1], ev[e]) : 0.f;
      const float len = inside > 0 ? gap : 0.f;
      acc += (double)len;
      cum[e] = (float)acc;
      seg[e] = len;
    }
  }
  __syncwarp();
  const float total = n ? cum[2 * n - 1] : 0.f;
  const size_t row2 = (size_t)r * 2 * k;
  for (int e = lane; e < 2 * k; e += 32) {
    float t = INFINITY, ci = total, ce = total, ac = 0.f;
    if (e < 2 * n) {
      t = ev[e];
      ci = cum[e];
      ce = sub(ci, seg[e]);
      ac = sub(t, ce);
    }
    out.times[row2 + e] = t;
    out.cum_incl[row2 + e] = ci;
    out.cum_excl[row2 + e] = ce;
    out.arc_corr[row2 + e] = ac;
  }

  // 5. The sample layout and the per-ray scalars.
  if (lane == 0) {
    const int necessary = (int)floorf(__fdiv_rn(total, in.step));
    const bool tiny = necessary == 0 && total > 0.f;
    out.total[r] = total;
    out.tiny[r] = tiny;
    out.n_steps[r] = tiny ? 1 : min(necessary, in.s);
    out.t_offset[r] = mul(in.u_off[r], tiny ? total : in.step);
    out.t_mesh[r] = t_mesh;
    out.tri_u[r] = mesh_hit ? best_u : 0.f;
    out.tri_v[r] = mesh_hit ? best_v : 0.f;
    out.tri[r] = tris.n == 0 ? 0 : best_j == 0x7fffffff ? max(tris.id(0), 0) : tris.id(best_j);
    out.alpha_last[r] = mesh_hit ? 1.f : 0.f;
    out.hit[r] = any_box || mesh_hit;
    for (int c = 0; c < 3; ++c) out.color_last[3 * r + c] = 0.f;
    const int over_hits = max(list.seen - k, 0);
    const int over_steps = max(necessary - in.s, 0);
    if (over_hits) atomicAdd(out.overflow, (unsigned long long)over_hits);
    if (over_steps) atomicAdd(out.overflow + 1, (unsigned long long)over_steps);
  }
}

template <int kCap>
cudaError_t launch(const Inputs& in, const Outputs& out, cudaStream_t stream) {
  const int grid = (in.rb + kWarps - 1) / kWarps;
  per_ray_kernel<kCap><<<grid, kThreads, 0, stream>>>(in, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One ray block.  rays_o, rays_d [rb, 3] f32 at strides (o_row, o_col),
// (d_row, d_col) floats (a row stride 0 repeats one ray), u_off [rb] f32; inv_rot [n_inst,
// 3, 3], inv_trans, origins, inst_center [n_inst, 3], inst_radius [n_inst];
// v0, e1, e2, tri_center [n_tri, 3], tri_radius [n_tri] (null when n_tri is
// 0); b_0, b_1 [3].  budget_inst / budget_tri: the cull budgets (0: not
// culled); pad_a, pad_b: the instance spheres' pad coefficients (fan_keep);
// cull: int32 [4 + budget_inst + budget_tri] (null when neither is
// culled): the two keep sets' counts, the culls that fit and that did not,
// then the kept instance ids and the kept triangle ids.  Outputs, each
// buffer carved in this order: f32 tk0, tk1, sel_a, sel_b [rb, k], times,
// cum_incl, cum_excl, arc_corr [rb, 2k], total, t_offset, t_mesh, tri_u,
// tri_v, alpha_last [rb], color_last [rb, 3]; int64 inst_idx [rb, k], tri
// [rb], overflow [2]; int32 n_steps [rb]; bool kvalid [rb, k], tiny [rb], hit
// [rb].  All contiguous.  Returns the first CUDA error of the launches.
int nt_per_ray(const void* rays_o, const void* rays_d, int o_row, int o_col, int d_row,
               int d_col, const void* u_off, int rb,
               const void* inv_rot, const void* inv_trans, const void* origins,
               const void* inst_center, const void* inst_radius, int n_inst, const void* v0,
               const void* e1, const void* e2, const void* tri_center, const void* tri_radius,
               int n_tri, const void* b_0, const void* b_1, int budget_inst, int budget_tri,
               float pad_a, float pad_b, void* cull, int k, int s, float step, int bf16, void* f32,
               void* i64, void* i32, void* flags, void* stream) {
  if (rb < 1 || o_row < 0 || o_col < 0 || d_row < 0 || d_col < 0 || n_inst < 1 || k < 1 || k > 128 ||
      k > n_inst || n_tri < 0 || budget_inst < 0 || budget_tri < 0 || !rays_o || !rays_d || !u_off || !inv_rot ||
      !inv_trans || !origins || !b_0 || !b_1 || !f32 || !i64 || !i32 || !flags ||
      (n_tri > 0 && (!v0 || !e1 || !e2)) || ((budget_inst || budget_tri) && !cull) ||
      (budget_inst && !inst_center) || (budget_tri && (!tri_center || !tri_radius)) ||
      (budget_inst && budget_inst < k) || !(pad_a >= 0.f) || !(pad_b >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t nk = (size_t)rb * k;
  float* f = (float*)f32;
  Outputs out;
  out.tk0 = f;
  out.tk1 = f + nk;
  out.sel_a = f + 2 * nk;
  out.sel_b = f + 3 * nk;
  out.times = f + 4 * nk;
  out.cum_incl = f + 6 * nk;
  out.cum_excl = f + 8 * nk;
  out.arc_corr = f + 10 * nk;
  float* scal = f + 12 * nk;
  out.total = scal;
  out.t_offset = scal + rb;
  out.t_mesh = scal + 2 * (size_t)rb;
  out.tri_u = scal + 3 * (size_t)rb;
  out.tri_v = scal + 4 * (size_t)rb;
  out.alpha_last = scal + 5 * (size_t)rb;
  out.color_last = scal + 6 * (size_t)rb;
  out.inst_idx = (int64_t*)i64;
  out.tri = (int64_t*)i64 + nk;
  out.overflow = (unsigned long long*)((int64_t*)i64 + nk + rb);
  out.n_steps = (int*)i32;
  out.kvalid = (bool*)flags;
  out.tiny = (bool*)flags + nk;
  out.hit = (bool*)flags + nk + rb;

  cudaError_t err = cudaMemsetAsync(out.overflow, 0, 2 * sizeof(int64_t), st);
  if (err != cudaSuccess) return (int)err;
  int* meta = (int*)cull;
  if (budget_inst || budget_tri) {
    const Spheres inst = {(const float*)inst_center, (const float*)inst_radius, n_inst,
                          budget_inst, pad_a, pad_b, meta + kMeta};
    const Spheres tri = {(const float*)tri_center, (const float*)tri_radius, n_tri, budget_tri,
                         0.f, 0.f, meta + kMeta + budget_inst};
    fan_cull_kernel<<<1, kFanThreads, 0, st>>>((const float*)rays_o, (const float*)rays_d,
                                               o_row, o_col, d_row, d_col, rb, inst, tri,
                                               meta);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  Inputs in;
  in.rays_o = (const float*)rays_o;
  in.rays_d = (const float*)rays_d;
  in.u_off = (const float*)u_off;
  in.o_row = o_row;
  in.o_col = o_col;
  in.d_row = d_row;
  in.d_col = d_col;
  in.rb = rb;
  in.inv_rot = (const float*)inv_rot;
  in.inv_trans = (const float*)inv_trans;
  in.origins = (const float*)origins;
  in.n_inst = n_inst;
  in.v0 = (const float*)v0;
  in.e1 = (const float*)e1;
  in.e2 = (const float*)e2;
  in.n_tri = n_tri;
  in.b_0 = (const float*)b_0;
  in.b_1 = (const float*)b_1;
  in.meta = (budget_inst || budget_tri) ? meta : nullptr;
  in.budget_inst = budget_inst;
  in.budget_tri = budget_tri;
  in.k = k;
  in.s = s;
  in.step = step;
  in.bf16 = bf16;
  if (k <= 32) return (int)launch<32>(in, out, st);
  if (k <= 64) return (int)launch<64>(in, out, st);
  return (int)launch<128>(in, out, st);
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
