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
// What bounds it on the H100: operations.  About 15 operations per
// (sample, hit slot) element against 20 B of tables per slot and 20 B of
// planes per sample; at the plush shapes (Rb 2048, S 1280, K 128) that is
// 5.0e9 operations against 57 MB, i.e. 0.075 ms of f32 arithmetic against
// 0.017 ms of memory.
//
// Design.  The TPU kernel put rays on lanes and K on sublanes and scanned
// with rolls; here one thread owns one (ray, sample) and walks K in a
// sequential loop, which is what a cumsum and a data-dependent pick want.
// A CTA covers TR rays x TS samples (TR * TS = 256 threads) and stages the
// TR rays' five [K] table rows in shared memory once (2.5 KB per ray at
// K = 128); every thread of a ray then reads them as broadcasts.  Nothing
// [Rb, S, K]-shaped is ever stored.  nearest_blend takes four passes over
// shared memory (active count and fallback, min distance, sum of w, then
// the running cum and the count of u > cum) and recomputes d_k each pass
// instead of keeping K values in registers.  Valid slots are a prefix of
// the K slots on the render path, so each ray's loop ends at its last valid
// slot (computed per ray while staging); the trailing slots, all inactive,
// still count toward u > cum exactly as in the full chain.  Every float
// operation is an explicit round-to-nearest intrinsic: the anchor distance
// uses the two fmas XLA contracts it to (its terms cancel, so that rounding
// decides the blend weights), everything else rounds each operation, as
// the plain PyTorch version does; the two differ only where a sum's order
// differs (the blend's sum and cumsum).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRandom = 0;
constexpr int kNearest = 1;
constexpr int kBlend = 2;

struct Row {
  const float* tk0;
  const float* tk1;
  const unsigned char* kv;
  const float* sa;
  const float* sb;
};

__device__ __forceinline__ bool is_active(const Row& row, int k, float t, bool no_act, int fk) {
  if (no_act) return k == fk;
  return row.kv[k] && row.tk0[k] <= t && t < row.tk1[k];
}

// max(sa + 2 t sb + t^2, 0) as XLA evaluates it: fma(t, t, fma(2 t, sb, sa)).
__device__ __forceinline__ float dist2(const Row& row, int k, float t) {
  return fmaxf(__fmaf_rn(t, t, __fmaf_rn(__fmul_rn(2.f, t), row.sb[k], row.sa[k])), 0.f);
}

__global__ void selk_resolve_kernel(const float* __restrict__ tk0, const float* __restrict__ tk1,
                                    const unsigned char* __restrict__ kvalid,
                                    const float* __restrict__ sel_a,
                                    const float* __restrict__ sel_b,
                                    const float* __restrict__ t_pt,
                                    const float* __restrict__ u_sel, int rb, int S, int K,
                                    int method, float blend_range, int* __restrict__ sel_out,
                                    float* __restrict__ p_out, int* __restrict__ n_out) {
  extern __shared__ float smem[];
  const int TS = blockDim.x, TR = blockDim.y;
  const int tid = threadIdx.y * TS + threadIdx.x;
  const int r0 = blockIdx.y * TR;
  const bool need_sab = method != kRandom;

  float* s_tk0 = smem;
  float* s_tk1 = s_tk0 + TR * K;
  float* s_sa = s_tk1 + TR * K;
  float* s_sb = s_sa + (need_sab ? TR * K : 0);
  int* s_end = reinterpret_cast<int*>(s_sb + (need_sab ? TR * K : 0));
  unsigned char* s_kv = reinterpret_cast<unsigned char*>(s_end + TR);

  if (tid < TR) s_end[tid] = 0;
  __syncthreads();
  for (int i = tid; i < TR * K; i += TS * TR) {
    const int lr = i / K, k = i - lr * K;
    const int r = r0 + lr;
    if (r < rb) {
      const long long g = (long long)r * K + k;
      const unsigned char v = kvalid[g];
      s_tk0[i] = tk0[g];
      s_tk1[i] = tk1[g];
      s_kv[i] = v;
      if (need_sab) {
        s_sa[i] = sel_a[g];
        s_sb[i] = sel_b[g];
      }
      if (v) atomicMax(&s_end[lr], k + 1);
    } else {
      s_kv[i] = 0;
    }
  }
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int s = blockIdx.x * TS + threadIdx.x;
  if (r >= rb || s >= S) return;
  const int lr = threadIdx.y;
  const Row row{s_tk0 + lr * K, s_tk1 + lr * K, s_kv + lr * K,
                need_sab ? s_sa + lr * K : nullptr, need_sab ? s_sb + lr * K : nullptr};
  // Slots at or past `end` are invalid; slot 0 stays in reach for the
  // all-invalid row, whose fallback is slot 0.
  const int end = max(s_end[lr], 1);
  const long long o = (long long)r * S + s;
  const float t = t_pt[o];

  // Pass 1: active count and the nearest-interval fallback.
  int n_act = 0, fk = 0;
  float best_iv = INFINITY;
  for (int k = 0; k < end; ++k) {
    if (!row.kv[k]) continue;
    const float a = row.tk0[k], b = row.tk1[k];
    n_act += (a <= t && t < b);
    const float iv = fmaxf(fmaxf(__fsub_rn(a, t), __fsub_rn(t, b)), 0.f);
    if (iv < best_iv) {
      best_iv = iv;
      fk = k;
    }
  }
  const bool no_act = n_act == 0;
  const int n = max(n_act, 1);

  int sel = 0;
  float p = 0.f;
  if (method == kRandom) {
    const float u = u_sel[o];
    const int target = min((int)floorf(__fmul_rn(u, (float)n)), n - 1);
    int rank = 0;
    for (int k = 0; k < end; ++k) {
      if (!is_active(row, k, t, no_act, fk)) continue;
      if (rank == target) {
        sel = k;
        break;
      }
      ++rank;
    }
  } else if (method == kNearest) {
    float best = INFINITY;
    for (int k = 0; k < end; ++k) {
      if (!is_active(row, k, t, no_act, fk)) continue;
      const float d2 = dist2(row, k, t);
      if (d2 < best) {
        best = d2;
        sel = k;
      }
    }
  } else {
    const float u = u_sel[o];
    // Pass 2: the nearest active anchor distance.
    float min_d = INFINITY;
    for (int k = 0; k < end; ++k)
      if (is_active(row, k, t, no_act, fk)) min_d = fminf(min_d, __fsqrt_rn(dist2(row, k, t)));
    const float reach = __fadd_rn(blend_range, min_d);
    // Pass 3: the sum of the weights.
    float wsum = 0.f;
    for (int k = 0; k < end; ++k)
      if (is_active(row, k, t, no_act, fk))
        wsum = __fadd_rn(wsum, fmaxf(__fsub_rn(reach, __fsqrt_rn(dist2(row, k, t))), 0.f));
    const float denom = fmaxf(wsum, 1e-20f);
    // Pass 4: the running cum and the count of u > cum.
    float cum = 0.f;
    int count = 0;
    for (int k = 0; k < end; ++k) {
      if (is_active(row, k, t, no_act, fk)) {
        const float w = fmaxf(__fsub_rn(reach, __fsqrt_rn(dist2(row, k, t))), 0.f);
        cum = __fadd_rn(cum, __fdiv_rn(w, denom));
      }
      count += u > cum;
    }
    if (u > cum) count += K - end;  // the trailing slots hold the last cum
    sel = min(count, K - 1);
    if (sel < end && is_active(row, sel, t, no_act, fk))
      p = __fdiv_rn(fmaxf(__fsub_rn(reach, __fsqrt_rn(dist2(row, sel, t))), 0.f), denom);
  }
  sel_out[o] = sel;
  p_out[o] = p;
  n_out[o] = n;
}

}  // namespace

extern "C" {

// tk0, tk1, sel_a, sel_b: [rb, K] f32; kvalid: [rb, K] bytes (0/1);
// t_pt, u_sel: [rb, S] f32; all contiguous.  sel_a/sel_b may be null for
// method 0 (random), u_sel for method 1 (nearest).  Outputs [rb, S]:
// sel (int32), p (f32), n (int32).  Methods: 0 random, 1 nearest,
// 2 nearest_blend.  Returns cudaGetLastError().
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
  int TS = 32;
  while (TS < S && TS < kThreads) TS *= 2;
  const size_t per_ray = (size_t)K * ((method != kRandom ? 4 : 2) * sizeof(float) + 1) + sizeof(int);
  int TR = kThreads / TS;
  while (TR > 1 && TR * per_ray > 48 * 1024) TR /= 2;
  const size_t smem = TR * per_ray;
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selk_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(TS, TR);
  const dim3 grid((S + TS - 1) / TS, (rb + TR - 1) / TR);
  selk_resolve_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tk0), static_cast<const float*>(tk1),
      static_cast<const unsigned char*>(kvalid), static_cast<const float*>(sel_a),
      static_cast<const float*>(sel_b), static_cast<const float*>(t_pt),
      static_cast<const float*>(u_sel), rb, S, K, method, blend_range, static_cast<int*>(sel),
      static_cast<float*>(p), static_cast<int*>(n));
  return (int)cudaGetLastError();
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
