// Per-sample overlap resolution over the K hit slots, for Hopper (sm_90a).
//
// Replaces: nerftex_tpu/kernels/selk_resolve.py, _selk_kernel (reached
// through _selk_call and the wrapper selk_resolve), itself the fused form of
// the XLA chain in nerftex_tpu/instancing/device.py _per_sample_grid.
//
// What it computes, for each (ray r, sample s) with t = t_pt[r, s] and
// u = u_sel[r, s], over the ray's K hit slots:
//   active_k = valid_k & tk0_k <= t < tk1_k; if none is active, the slot
//     with the smallest clamped interval distance (the first such) alone;
//   random: the floor(u * n)-th active slot by rank;
//   nearest: the first minimum of max(sa_k + 2 t sb_k + t^2, 0) over the
//     active slots;
//   nearest_blend: w_k = max(range + min_d - d_k, 0) over the active
//     anchor distances d_k = sqrt(that), prob_k = w_k / max(sum w, 1e-20),
//     sel = #(k : u > cumsum(prob)_k) clipped to K - 1, p_sel = prob_sel.
// Outputs sel_k (int32), p_sel (f32, 0 for nearest/random) and n_active
// (int32, clamped to >= 1), each [Rb, S].
//
// What bounds it on the H100.  A sample's answer depends only on the few
// slots whose intervals can contain t (3.1 per sample on the plush frame,
// 11.5 on the bench frame's deeply overlapping carpet), so this kernel
// finds those directly; the work left is bound by the bytes, the planes
// (16-20 B per sample in and out) and the valid part of the tables.  What
// holds it above that is latency: each sample is a chain of dependent
// shared-memory loads, a square root per active slot and a division per
// weighed slot up to the pick.
//
// Design.  A CTA covers TR whole rays (or, past 2048 samples, an even chunk
// of one ray's samples) in two phases:
//  1. Stage, one warp per ray (stage_ray): the ray's validity bytes, with
//     slots 0-31's tables loaded beside them; then, for the slots below the
//     last valid one only, one 16-byte record per slot {tk0, tk1, sel_a,
//     sel_b} (an invalid slot is {+inf, -inf, ..}: never active, at interval
//     distance +inf; a slot costs one LDS.128), the prefix max of tk1 by a
//     shuffle scan, and a flag for the render layout (valid slots a prefix,
//     tk0 non-decreasing, each finite with tk0 < tk1).  The tables are plain
//     coalesced loads: cp.async cannot interleave four tables or encode
//     validity.  The thread's first t and u are loaded before staging.
//  2. One thread per sample.  A flagged ray's stabbing window [lo, hi) comes
//     from two binary searches: hi = #(tk0 <= t), lo = the first slot whose
//     prefix max of tk1 exceeds t.  It holds every active slot and is empty
//     exactly when none is active; then the nearest interval needs no scan:
//     left of hi every interval ended at or before t, so the first minimum
//     of t - tk1 is the first slot whose prefix max rounds to the same
//     difference (a third binary search; the first slot attaining the
//     maximum is not always it, as rounding can tie), and right of hi it is
//     slot hi.  Unflagged rays scan [0, end) once.  nearest and random walk
//     the window; nearest_blend keeps only its candidates (see blend).
// Geometry, from the launch: about 256 samples per CTA (short rays packed,
// kept to two CTAs per SM at least), threads rounded to the CTA's samples,
// so the frames' sorted blocks (S_b from 1 to 1280) and K tiers (8 .. 128)
// fill the card with one sample per thread and stage only their own rows.
// Chosen by sweeping samples per CTA (256-1024), threads (128, 256) and the
// candidate list (0-32) on both frames' captured launches.
//
// Rounding: every float operation is an explicit round-to-nearest
// intrinsic, in the same order as the scan over all valid slots that this
// design replaced (the anchor distance uses the two fmas XLA contracts it
// to; the weight sum and cum in slot order), so sel_k, p_sel and n_active
// equal that scan's bit for bit on any input.  The plain PyTorch version differs only where a sum's order
// differs (the blend's sum and cumsum).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRandom = 0;
constexpr int kNearest = 1;
constexpr int kBlend = 2;
constexpr int kThreads = 256;            // most threads per CTA
constexpr int kSamplesPerCta = 256;      // target when short rays are packed
constexpr int kMinCtasPerSm = 2;         // packing stops short of fewer CTAs than this
constexpr int kMaxSamplesPerCta = 2048;  // past this a ray's samples are split over CTAs
constexpr int kScratch = 16;             // blend candidates kept in shared memory

// One staged ray: a record per slot and its metadata.
struct RayView {
  const float4* rec;  // {tk0, tk1, sel_a, sel_b}; invalid slots {+inf, -inf, sel_a, sel_b}
  const float* pmax;  // prefix max of tk1 over the valid slots
  int end;            // last valid slot + 1
  int first;          // first valid slot, 0 if none
  bool sorted;        // render layout (see stage_ray)
};

// The slots [b, e) that hold every active slot, with their count n (0: not
// counted yet); or, when none is active, the fallback slot alone (forced).
struct Window {
  int b, e, n;
  bool forced;
};

// max(sa + 2 t sb + t^2, 0) as XLA evaluates it: fma(t, t, fma(2 t, sb, sa)).
__device__ __forceinline__ float dist2(float4 r, float t) {
  return fmaxf(__fmaf_rn(t, t, __fmaf_rn(__fmul_rn(2.f, t), r.w, r.z)), 0.f);
}

__device__ __forceinline__ bool covers(float4 r, float t) { return r.x <= t && t < r.y; }

// The clamped interval distance max(tk0 - t, t - tk1, 0).
__device__ __forceinline__ float gap(float4 r, float t) {
  return fmaxf(fmaxf(__fsub_rn(r.x, t), __fsub_rn(t, r.y)), 0.f);
}

__device__ __forceinline__ Window fallback(int k) { return {k, k + 1, 1, true}; }

__device__ Window find_window(const RayView& ray, float t) {
  // A NaN t is in no interval and at distance max(NaN, 0) = 0 from every
  // valid one: the first valid slot.
  if (isnan(t)) return fallback(ray.first);
  if (ray.sorted && isfinite(t)) {
    int a = 0, c = ray.end;
    while (a < c) {
      const int m = (a + c) >> 1;
      if (ray.rec[m].x <= t) a = m + 1; else c = m;
    }
    const int hi = a;
    a = 0;
    c = hi;
    while (a < c) {
      const int m = (a + c) >> 1;
      if (ray.pmax[m] > t) c = m; else a = m + 1;
    }
    if (a < hi) return {a, hi, 0, false};
    // None active.  Left of hi: t >= tk1, distance fl(t - tk1), smallest
    // for the largest tk1; its first attainment is the first slot whose
    // prefix max gives the same rounded difference.  Right of hi: fl(tk0 -
    // t), smallest at hi.  The scan's first-minimum rule: the left wins
    // ties, and with nothing below +inf the scan keeps slot 0.
    float vl = INFINITY, vr = INFINITY;
    int kl = 0;
    if (hi > 0) {
      vl = __fsub_rn(t, ray.pmax[hi - 1]);
      a = 0;
      c = hi - 1;
      while (a < c) {
        const int m = (a + c) >> 1;
        if (__fsub_rn(t, ray.pmax[m]) <= vl) c = m; else a = m + 1;
      }
      kl = a;
    }
    if (hi < ray.end) vr = __fsub_rn(ray.rec[hi].x, t);
    return fallback(vl <= vr ? (vl < INFINITY ? kl : 0) : hi);
  }
  int n = 0, b = 0, e = 0, fk = 0;
  float best = INFINITY;
  for (int k = 0; k < ray.end; ++k) {
    const float4 r = ray.rec[k];
    if (covers(r, t)) {
      if (n == 0) b = k;
      e = k + 1;
      ++n;
    }
    const float g = gap(r, t);
    if (g < best) {
      best = g;
      fk = k;
    }
  }
  return n ? Window{b, e, n, false} : fallback(fk);
}

__device__ __forceinline__ bool is_active(const Window& w, float4 r, float t) {
  return w.forced || covers(r, t);
}

// The picked slot's probability, recomputed: w_sel / denom if `sel` is an
// active slot of the window, else 0.
__device__ __forceinline__ float blend_p(const RayView& ray, const Window& w, int sel, float reach,
                                         float denom, float t) {
  if (sel < w.b || sel >= w.e) return 0.f;
  const float4 r = ray.rec[sel];
  if (!is_active(w, r, t)) return 0.f;
  return __fdiv_rn(fmaxf(__fsub_rn(reach, __fsqrt_rn(dist2(r, t))), 0.f), denom);
}

// nearest_blend over the window, bit-equal to summing over every active slot
// in slot order.  Pass 1 takes each active slot's anchor distance d and
// min_d, and keeps the candidates: the slots whose d is below the running
// min_d + range.  Every slot with a nonzero weight max(range + min_d - d, 0)
// is one (rounding is monotone and min_d only falls), and a zero weight
// leaves the weight sum and the cum unchanged to the bit, so the sum and the
// cum walk run over the candidates alone, in slot order.  The pick's count
// of u > cum_k: the cum is 0 before the window, non-decreasing through it
// (each step adds w / denom >= 0, or turns NaN, which no u exceeds) and
// holds after it, so the count is the first slot whose cum u does not
// exceed, which is a candidate (elsewhere the cum equals an earlier value
// that u exceeded); past the window the count is closed form.  Candidates
// live in this thread's column of shared memory (`scr`, stride `stride`:
// kScratch distances, then kScratch slot indices); with more, the sum and
// walk recompute over the window.
__device__ void blend(const RayView& ray, const Window& w, int K, float blend_range, float t,
                      float u, float* scr, int stride, int& sel, float& p, int& n) {
  int* scr_k = reinterpret_cast<int*>(scr + kScratch * stride);
  float min_d = INFINITY;
  int n_cand = 0;
  n = 0;
  for (int k = w.b; k < w.e; ++k) {
    const float4 r = ray.rec[k];
    if (!is_active(w, r, t)) continue;
    ++n;
    const float d = __fsqrt_rn(dist2(r, t));
    min_d = fminf(min_d, d);
    if (d < __fadd_rn(blend_range, min_d)) {
      if (n_cand < kScratch) {
        scr[n_cand * stride] = d;
        scr_k[n_cand * stride] = k;
      }
      ++n_cand;
    }
  }
  const float reach = __fadd_rn(blend_range, min_d);
  const bool listed = n_cand <= kScratch;
  const int m = listed ? n_cand : w.e - w.b;
  // Term j: the weight and slot of candidate j, or of window slot b + j
  // (weight -1 if inactive) when the candidates did not fit.
  auto term = [&](int j, int& k) {
    float d;
    if (listed) {
      d = scr[j * stride];
      k = scr_k[j * stride];
    } else {
      k = w.b + j;
      const float4 r = ray.rec[k];
      if (!is_active(w, r, t)) return -1.f;
      d = __fsqrt_rn(dist2(r, t));
    }
    return fmaxf(__fsub_rn(reach, d), 0.f);
  };
  float wsum = 0.f;
  for (int j = 0; j < m; ++j) {
    int k;
    const float wj = term(j, k);
    if (wj >= 0.f) wsum = __fadd_rn(wsum, wj);
  }
  const float denom = fmaxf(wsum, 1e-20f);
  bool p_known = false;
  int count = 0;
  if (u > 0.f) {
    float cum = 0.f;
    count = -1;
    for (int j = 0; j < m; ++j) {
      int k;
      const float wj = term(j, k);
      if (wj < 0.f) continue;
      const float q = __fdiv_rn(wj, denom);
      cum = __fadd_rn(cum, q);
      if (!(u > cum)) {
        count = k;
        p = q;
        p_known = true;
        break;
      }
    }
    if (count < 0) count = u > cum ? K : w.e;
  }
  sel = min(count, K - 1);
  if (!p_known || sel != count) p = blend_p(ray, w, sel, reach, denom, t);
}

__device__ void resolve_sample(const RayView& ray, int K, int method, float blend_range, float t,
                               float u, float* scr, int stride, int& sel, float& p, int& n) {
  const Window w = find_window(ray, t);
  sel = 0;
  p = 0.f;
  if (method == kRandom) {
    n = w.n;
    if (n == 0)
      for (int k = w.b; k < w.e; ++k) n += covers(ray.rec[k], t);
    const int target = min((int)floorf(__fmul_rn(u, (float)n)), n - 1);
    int rank = 0;
    for (int k = w.b; k < w.e; ++k) {
      if (!is_active(w, ray.rec[k], t)) continue;
      if (rank == target) {
        sel = k;
        break;
      }
      ++rank;
    }
  } else if (method == kNearest) {
    float best = INFINITY;
    n = 0;
    for (int k = w.b; k < w.e; ++k) {
      const float4 r = ray.rec[k];
      if (!is_active(w, r, t)) continue;
      ++n;
      const float d2 = dist2(r, t);
      if (d2 < best) {
        best = d2;
        sel = k;
      }
    }
  } else {
    blend(ray, w, K, blend_range, t, u, scr, stride, sel, p, n);
  }
}

// One warp stages one ray.  Its validity bytes come first (end = last valid
// slot + 1, the first valid slot, the count), with slots 0-31's tables
// loaded beside them, since most rays of a frame end there; then only slots
// [0, max(end, 1)) are staged, the only ones a sample can reach (slot 0 is
// an empty ray's fallback): a record each, the prefix max of tk1, and the
// render-layout flag `sorted` (valid slots [0, end), tk0 non-decreasing over
// them, each finite with tk0 < tk1).
__device__ void stage_ray(const float* __restrict__ tk0, const float* __restrict__ tk1,
                          const unsigned char* __restrict__ kvalid,
                          const float* __restrict__ sel_a, const float* __restrict__ sel_b,
                          long long g, int K, bool need_sab, int lane, float4* rec, float* pmax,
                          int* meta) {
  float4 head = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < K) {
    head.x = tk0[g + lane];
    head.y = tk1[g + lane];
    if (need_sab) {
      head.z = sel_a[g + lane];
      head.w = sel_b[g + lane];
    }
  }
  int end = 0, first = -1, n_valid = 0;
  for (int c = 0; c < K; c += 128) {
    bool v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = c + 32 * j + lane;
      v[j] = k < K && kvalid[g + k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned bal = __ballot_sync(~0u, v[j]);
      if (bal) {
        end = c + 32 * j + 32 - __clz(bal);
        if (first < 0) first = c + 32 * j + __ffs(bal) - 1;
      }
      n_valid += __popc(bal);
    }
  }
  const int n_stage = max(end, 1);
  bool ok = n_valid == end;
  float run = -INFINITY, prev_last = -INFINITY;
  for (int c = 0; c < n_stage; c += 32) {
    const int k = c + lane;
    const bool in = k < n_stage;
    float4 x = head;
    if (c > 0 && in) {
      x.x = tk0[g + k];
      x.y = tk1[g + k];
      if (need_sab) {
        x.z = sel_a[g + k];
        x.w = sel_b[g + k];
      }
    }
    const bool v = in && kvalid[g + k];
    const float4 r = make_float4(v ? x.x : INFINITY, v ? x.y : -INFINITY, x.z, x.w);
    if (in) rec[k] = r;
    float prev = __shfl_up_sync(~0u, r.x, 1);
    if (lane == 0) prev = prev_last;
    const bool bad = v && !(isfinite(r.x) && isfinite(r.y) && r.x < r.y && prev <= r.x);
    ok = ok && !__any_sync(~0u, bad);
    prev_last = __shfl_sync(~0u, r.x, 31);
    float m = v ? r.y : -INFINITY;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(~0u, m, off);
      if (lane >= off) m = fmaxf(m, y);
    }
    m = fmaxf(m, run);
    run = __shfl_sync(~0u, m, 31);
    if (in) pmax[k] = m;
  }
  if (lane == 0) {
    meta[0] = end;
    meta[1] = max(first, 0);
    meta[2] = ok;
  }
}

__global__ void __launch_bounds__(kThreads) selk_resolve_kernel(
    const float* __restrict__ tk0, const float* __restrict__ tk1,
    const unsigned char* __restrict__ kvalid, const float* __restrict__ sel_a,
    const float* __restrict__ sel_b, const float* __restrict__ t_pt,
    const float* __restrict__ u_sel, int rb, int S, int K, int method, float blend_range,
    int TR, int SC, int* __restrict__ sel_out, float* __restrict__ p_out,
    int* __restrict__ n_out) {
  extern __shared__ float4 smem[];
  float4* s_rec = smem;                                        // [TR * K]
  float* s_pmax = reinterpret_cast<float*>(s_rec + TR * K);   // [TR * K]
  int* s_meta = reinterpret_cast<int*>(s_pmax + TR * K);      // [TR][3]
  float* s_scr = reinterpret_cast<float*>(s_meta + 3 * TR);   // [2 kScratch][threads], blend only
  const int tid = threadIdx.x, threads = blockDim.x;
  const int r0 = blockIdx.x * TR, s0 = blockIdx.y * SC;
  const int nr = min(TR, rb - r0), ns = min(SC, S - s0);
  const int total = nr * ns;
  const bool need_sab = method != kRandom, need_u = method != kNearest;

  // The first sample's planes, in flight while the tables are staged.
  float t_next = 0.f, u_next = 0.f;
  if (tid < total) {
    const int lr = tid / ns;
    const long long o = (long long)(r0 + lr) * S + s0 + (tid - lr * ns);
    t_next = t_pt[o];
    if (need_u) u_next = u_sel[o];
  }

  // 1. Stage the rays, one warp each.
  const int warp = tid >> 5, lane = tid & 31;
  for (int lr = warp; lr < nr; lr += threads >> 5)
    stage_ray(tk0, tk1, kvalid, sel_a, sel_b, (long long)(r0 + lr) * K, K, need_sab, lane,
              s_rec + lr * K, s_pmax + lr * K, s_meta + 3 * lr);
  __syncthreads();

  // 2. One thread per sample, the next sample's planes prefetched.
  for (int f = tid; f < total; f += threads) {
    const float t = t_next, u = u_next;
    const int lr = f / ns;
    const long long o = (long long)(r0 + lr) * S + s0 + (f - lr * ns);
    const int fn = f + threads;
    if (fn < total) {
      const int lrn = fn / ns;
      const long long on = (long long)(r0 + lrn) * S + s0 + (fn - lrn * ns);
      t_next = t_pt[on];
      if (need_u) u_next = u_sel[on];
    }
    const int* meta = s_meta + 3 * lr;
    const RayView ray{s_rec + lr * K, s_pmax + lr * K, meta[0], meta[1], meta[2] != 0};
    int sel, n;
    float p;
    resolve_sample(ray, K, method, blend_range, t, u, s_scr + tid, threads, sel, p, n);
    sel_out[o] = sel;
    p_out[o] = p;
    n_out[o] = n;
  }
}

}  // namespace

extern "C" {

// tk0, tk1, sel_a, sel_b: [rb, K] f32; kvalid: [rb, K] bytes (0/1);
// t_pt, u_sel: [rb, S] f32; all contiguous.  sel_a/sel_b may be null for
// method 0 (random), u_sel for method 1 (nearest).  Outputs [rb, S]:
// sel (int32), p (f32), n (int32).  Methods: 0 random, 1 nearest,
// 2 nearest_blend.  The launch geometry is sized to the current device's
// SM count.  Returns cudaGetLastError().
int nt_selk_resolve(const void* tk0, const void* tk1, const void* kvalid, const void* sel_a,
                    const void* sel_b, const void* t_pt, const void* u_sel, int rb, int S, int K,
                    int method, float blend_range, void* sel, void* p, void* n, void* stream) {
  if (rb < 1 || S < 1 || K < 1 || method < kRandom || method > kBlend) {
    return (int)cudaErrorInvalidValue;
  }
  if (!tk0 || !tk1 || !kvalid || !t_pt || (method != kRandom && (!sel_a || !sel_b)) ||
      (method != kNearest && !u_sel)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, n_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t per_ray = (size_t)K * (sizeof(float4) + sizeof(float)) + 3 * sizeof(int);
  // Samples per CTA: a whole ray up to kMaxSamplesPerCta, else even chunks.
  const int chunks = (S + kMaxSamplesPerCta - 1) / kMaxSamplesPerCta;
  const int SC = (S + chunks - 1) / chunks;
  // Rays per CTA: about kSamplesPerCta samples, kMinCtasPerSm CTAs per SM
  // at least, 48 KB of shared memory at most.
  int TR = chunks > 1 ? 1 : max(1, kSamplesPerCta / S);
  while (TR > 1 && (rb + TR - 1) / TR < kMinCtasPerSm * n_sms) --TR;
  // Threads: the CTA's samples rounded up to whole warps, at most kThreads;
  // nearest_blend adds each one's candidate list (kScratch floats and ints).
  auto threads_for = [&](int tr) { return min(kThreads, (tr * SC + 31) / 32 * 32); };
  auto smem_for = [&](int tr) {
    return tr * per_ray + (method == kBlend ? (size_t)kScratch * threads_for(tr) * 8 : 0);
  };
  while (TR > 1 && smem_for(TR) > 48 * 1024) --TR;
  const int threads = threads_for(TR);
  const size_t smem = smem_for(TR);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(selk_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((rb + TR - 1) / TR, chunks);
  selk_resolve_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tk0), static_cast<const float*>(tk1),
      static_cast<const unsigned char*>(kvalid), static_cast<const float*>(sel_a),
      static_cast<const float*>(sel_b), static_cast<const float*>(t_pt),
      static_cast<const float*>(u_sel), rb, S, K, method, blend_range, TR, SC,
      static_cast<int*>(sel), static_cast<float*>(p), static_cast<int*>(n));
  return (int)cudaGetLastError();
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
