// Bilinear parameter-texture fetch for Hopper (sm_90a).
//
// Replaces: nerftex_tpu/kernels/tex_gather.py, _quad_kernel (reached through
// _quad_fetch and sample_channel_quads_pallas).  The TPU kernel fetches the
// four corner bytes with a one-hot bf16 matmul because gathers are slow on
// the TPU; a GPU gathers natively, so this kernel loads the corners directly.
//
// What bounds it on the H100: bytes.  Each sample reads 8 B of uv and writes
// 4 B and does ~20 flops; the [W, H] f32 channel (256 KB for the carpet's
// 256x256 checkerboard) stays resident in the 50 MB L2, so device memory
// sees ~12 B per sample.
//
// Design: one thread per sample, uv read as one float2, the four corners
// read from the f32 channel, and the lerp done in the kernel.  The index
// math is the JAX wrapper's (tex_gather.py sample_channel_quads_pallas):
// x = clip(u, 0, 1) * (w - 1), x0 = clip(floor(x), 0, w - 2), likewise y.
// For byte-valued textures the corners equal the TPU kernel's byte-table
// values exactly (b / 255 == channel value is the table's admission test),
// and textures that are not byte-valued work too.  The lerp uses
// round-to-nearest intrinsics (no fma contraction), so the result equals
// the plain PyTorch version's separately rounded operations.

#include <cuda_runtime.h>

__global__ void tex_fetch_kernel(const float* __restrict__ tex, int w, int h,
                                 const float2* __restrict__ uv, float* __restrict__ out,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2 p = uv[i];
  const float x = __fmul_rn(fminf(fmaxf(p.x, 0.f), 1.f), (float)(w - 1));
  const float y = __fmul_rn(fminf(fmaxf(p.y, 0.f), 1.f), (float)(h - 1));
  const int x0 = min(max((int)floorf(x), 0), max(w - 2, 0));
  const int y0 = min(max((int)floorf(y), 0), max(h - 2, 0));
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float fx = __fsub_rn(x, (float)x0);
  const float fy = __fsub_rn(y, (float)y0);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const float q00 = __ldg(tex + x0 * h + y0);
  const float q01 = __ldg(tex + x0 * h + y1);
  const float q10 = __ldg(tex + x1 * h + y0);
  const float q11 = __ldg(tex + x1 * h + y1);
  const float c0 = __fadd_rn(__fmul_rn(q00, gy), __fmul_rn(q01, fy));
  const float c1 = __fadd_rn(__fmul_rn(q10, gy), __fmul_rn(q11, fy));
  out[i] = __fadd_rn(__fmul_rn(c0, gx), __fmul_rn(c1, fx));
}

extern "C" {

// tex: [w, h] f32 contiguous (u indexes w, v from the bottom indexes h);
// uv: [n, 2] f32 contiguous; out: [n] f32.  Returns cudaGetLastError().
int nt_tex_fetch(const void* tex, int w, int h, const void* uv, void* out, long long n,
                 void* stream) {
  if (n < 1 || w < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  tex_fetch_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tex), w, h, static_cast<const float2*>(uv),
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
