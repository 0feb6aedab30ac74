// Bilinear parameter-texture fetch for Hopper (sm_90a).
//
// Replaces: nerftex_tpu/kernels/tex_gather.py, _quad_kernel (reached through
// _quad_fetch and sample_channel_quads_pallas).  The TPU kernel fetches the
// four corner bytes with a one-hot bf16 matmul because gathers are slow on
// the TPU; a GPU gathers natively, so this kernel loads the corners directly.
//
// What bounds it on the H100: bytes.  Each sample reads 8 B of uv and writes
// 4 B and does ~20 flops; the texture table stays resident in the 50 MB L2,
// so device memory sees ~12 B per sample.
//
// Two variants, chosen by the caller:
//   * byte_quad: for a byte-valued channel (every texel is b / 255, as
//     8-bit PNGs give), a uchar4 table [max(w-1,1)][max(h-1,1)] holds the
//     four corner bytes (x0,y0), (x0,y1), (x1,y0), (x1,y1) of every bilinear
//     footprint, so a sample costs one 4-byte load (one L2 sector) instead
//     of four scattered f32 loads; the table is 255 KB for 256x256.  The
//     corner values are b / 255 correctly rounded, as the loader's division
//     made the channel, so they equal its texels to the bit: q = b * r with
//     r = 1/255, corrected once by its exact residual fma(-q, 255, b) (for
//     every byte this equals __fdiv_rn(b, 255) at three flops).
//   * f32: four loads from the [w, h] f32 channel, for any channel.
// One thread per sample (a float2 uv load, one store): the frames' fetches
// are 5k-2.6M samples of coherent uv, where more samples per thread
// (vectorised float4 uv, a grid sized to the card) measured no faster.
// The index math is the JAX wrapper's
// (tex_gather.py sample_channel_quads_pallas):
// x = clip(u, 0, 1) * (w - 1), x0 = clip(floor(x), 0, w - 2), likewise y.
// The lerp uses round-to-nearest intrinsics (no fma contraction), so the
// result equals the plain PyTorch version's separately rounded operations.

#include <cuda_runtime.h>

struct Footprint {
  int x0, y0, x1, y1;
  float fx, fy;
};

__device__ __forceinline__ Footprint footprint(float u, float v, int w, int h) {
  Footprint f;
  const float x = __fmul_rn(fminf(fmaxf(u, 0.f), 1.f), (float)(w - 1));
  const float y = __fmul_rn(fminf(fmaxf(v, 0.f), 1.f), (float)(h - 1));
  f.x0 = min(max((int)floorf(x), 0), max(w - 2, 0));
  f.y0 = min(max((int)floorf(y), 0), max(h - 2, 0));
  f.x1 = min(f.x0 + 1, w - 1);
  f.y1 = min(f.y0 + 1, h - 1);
  f.fx = __fsub_rn(x, (float)f.x0);
  f.fy = __fsub_rn(y, (float)f.y0);
  return f;
}

__device__ __forceinline__ float lerp4(float q00, float q01, float q10, float q11,
                                       const Footprint& f) {
  const float gx = __fsub_rn(1.f, f.fx);
  const float gy = __fsub_rn(1.f, f.fy);
  const float c0 = __fadd_rn(__fmul_rn(q00, gy), __fmul_rn(q01, f.fy));
  const float c1 = __fadd_rn(__fmul_rn(q10, gy), __fmul_rn(q11, f.fy));
  return __fadd_rn(__fmul_rn(c0, gx), __fmul_rn(c1, f.fx));
}

__device__ __forceinline__ float byte_value(unsigned int b) {
  const float r = 1.f / 255.f, x = (float)b, q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.f, x), r, q);
}

template <bool QUADS>
__device__ __forceinline__ float fetch(const void* __restrict__ table, int w, int h, float u,
                                       float v) {
  const Footprint f = footprint(u, v, w, h);
  if constexpr (QUADS) {
    const uchar4 q = __ldg(static_cast<const uchar4*>(table) + f.x0 * max(h - 1, 1) + f.y0);
    return lerp4(byte_value(q.x), byte_value(q.y), byte_value(q.z), byte_value(q.w), f);
  } else {
    const float* tex = static_cast<const float*>(table);
    return lerp4(__ldg(tex + f.x0 * h + f.y0), __ldg(tex + f.x0 * h + f.y1),
                 __ldg(tex + f.x1 * h + f.y0), __ldg(tex + f.x1 * h + f.y1), f);
  }
}

template <bool QUADS>
__global__ void __launch_bounds__(256)
    tex_fetch_kernel(const void* __restrict__ table, int w, int h, const float2* __restrict__ uv,
                     float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2 p = __ldg(uv + i);
  out[i] = fetch<QUADS>(table, w, h, p.x, p.y);
}

extern "C" {

// variant 0: table = uchar4 quads [max(w-1,1)][max(h-1,1)]; variant 1:
// table = the [w, h] f32 channel (u indexes w, v from the bottom indexes h).
// uv: [n, 2] f32 contiguous; out: [n] f32.  Returns cudaGetLastError() of
// the launch.
int nt_tex_fetch(int variant, const void* table, int w, int h, const void* uv, void* out,
                 long long n, void* stream) {
  if (n < 1 || w < 1 || h < 1 || (variant != 0 && variant != 1)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* uv2 = static_cast<const float2*>(uv);
  float* o = static_cast<float*>(out);
  if (variant == 0)
    tex_fetch_kernel<true><<<blocks, threads, 0, s>>>(table, w, h, uv2, o, n);
  else
    tex_fetch_kernel<false><<<blocks, threads, 0, s>>>(table, w, h, uv2, o, n);
  return (int)cudaGetLastError();
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
