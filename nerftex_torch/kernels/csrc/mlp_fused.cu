// Fused ParamNerf inference forward for Hopper (sm_90a).
//
// Replaces: nerftex_tpu/kernels/mlp_pallas.py, make_fused_apply (the Pallas
// kernel built by its kernel_factory).  The chain is the 8x256 ReLU trunk
// with the [pos_map, h] skip concat, the density head, the bottleneck, the
// [dir_map, h] concat, the color layers, pre_color and the color head,
// giving out[N, 4] = (rgb logits, density).  Encodings and the parameter
// MLPs stay outside, as in the Pallas wrapper.
//
// What bounds it on the H100: operations.  One sample costs about 1.4 MFLOP
// (699k multiply-adds) against 306 B of bf16 input and 16 B of output, far
// above the ~295 FLOP/B ridge, so the floor is the tensor-core rate
// (989 TFLOP/s bf16 dense; 67 TFLOP/s for the f32 FMA variant).
//
// Design: one block owns a tile of TILE_M samples and keeps every
// activation of the chain in shared memory (pos_map, dir_map and two
// ping-pong hidden buffers), so device memory sees only the inputs, the
// weights and the [N, 4] output.  The weights (~1.4 MB bf16) are read from
// global memory and stay L2-resident across blocks.  Layers are described
// by a small table (input segments, padded K, N, destination, ReLU), so the
// same kernel runs any ParamNerf topology with width <= 256.
//   * bf16 operands: WMMA 16x16x16 tiles with f32 accumulation; each layer's
//     output is rounded to bf16 (the JAX bf16 path rounds every dense).
//   * f32 operands: plain FMA, one output column per thread, which is what
//     the TPU kernel computes.
// A simple kernel that is right comes first: wgmma/TMA pipelining is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define TILE_M 64
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define MAX_W 256
#define MAX_LAYERS 32
#define LD_PAD 8
#define DESC_FIELDS 11

// Buffer ids in shared memory; OUT_DST writes columns of the global output.
#define BUF_POS 0
#define BUF_DIR 1
#define OUT_DST -1

struct LayerDesc {
  long long w_off;  // element offset of this layer's [K_pad, n_pad] weights
  long long b_off;  // element offset of its n_pad biases
  int src0, k0;     // first input segment: buffer id, padded width
  int src1, k1;     // optional second segment (src1 < 0: none)
  int n_pad;        // output width, multiple of 16, <= MAX_W
  int dst;          // buffer id, or OUT_DST
  int n_out;        // real output columns (heads)
  int out_col;      // first output column for OUT_DST
  int relu;
};

struct LayerTable {
  int n_layers;
  LayerDesc l[MAX_LAYERS];
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void emit(const LayerDesc& L, T* const* buf, const int* ld, float* out,
                                     int row0, int n, int row, int col, float y) {
  if (L.relu) y = fmaxf(y, 0.f);
  T yt = from_float<T>(y);
  if (L.dst >= 0) {
    buf[L.dst][row * ld[L.dst] + col] = yt;
  } else if (col < L.n_out && row0 + row < n) {
    out[(long long)(row0 + row) * 4 + L.out_col + col] = to_float(yt);
  }
}

// bf16: warp w owns output column tiles w and w + NWARPS, all TILE_M rows.
__device__ void layer_bf16(const LayerDesc& L, bf16* const* buf, const int* ld, const bf16* W,
                           const float* B, float* stage, float* out, int row0, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_ct = L.n_pad / 16;
  const int c0 = warp, c1 = warp + NWARPS;
  if (c0 >= n_ct) return;
  const bool has1 = c1 < n_ct;
  const bf16* w = W + L.w_off;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][TILE_M / 16];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < TILE_M / 16; ++r) wmma::fill_fragment(acc[j][r], 0.f);

  int kbase = 0;
  for (int s = 0; s < 2; ++s) {
    const int src = s == 0 ? L.src0 : L.src1;
    if (src < 0) break;
    const int kseg = s == 0 ? L.k0 : L.k1;
    const bf16* a_base = buf[src];
    const int lda = ld[src];
    for (int k = 0; k < kseg; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[TILE_M / 16];
#pragma unroll
      for (int r = 0; r < TILE_M / 16; ++r)
        wmma::load_matrix_sync(a[r], a_base + r * 16 * lda + k, lda);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, w + (long long)(kbase + k) * L.n_pad + c0 * 16, L.n_pad);
#pragma unroll
      for (int r = 0; r < TILE_M / 16; ++r) wmma::mma_sync(acc[0][r], a[r], b, acc[0][r]);
      if (has1) {
        wmma::load_matrix_sync(b, w + (long long)(kbase + k) * L.n_pad + c1 * 16, L.n_pad);
#pragma unroll
        for (int r = 0; r < TILE_M / 16; ++r) wmma::mma_sync(acc[1][r], a[r], b, acc[1][r]);
      }
    }
    kbase += kseg;
  }

  // Epilogue through a per-warp staging tile: the accumulator's register
  // layout is opaque, so each tile goes to shared memory first.
  float* st = stage + warp * 256;
  for (int j = 0; j < 2; ++j) {
    if (j == 1 && !has1) break;
    const int c = j == 0 ? c0 : c1;
#pragma unroll
    for (int r = 0; r < TILE_M / 16; ++r) {
      wmma::store_matrix_sync(st, acc[j][r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int col = c * 16 + (e & 15);
        emit<bf16>(L, buf, ld, out, row0, n, r * 16 + (e >> 4), col, st[e] + B[L.b_off + col]);
      }
      __syncwarp();
    }
  }
}

// f32: thread t owns output column t for all TILE_M rows.
__device__ void layer_f32(const LayerDesc& L, float* const* buf, const int* ld, const float* W,
                          const float* B, float* out, int row0, int n) {
  const int t = threadIdx.x;
  if (t >= L.n_pad) return;
  const float* w = W + L.w_off;
  float acc[TILE_M];
#pragma unroll
  for (int r = 0; r < TILE_M; ++r) acc[r] = 0.f;

  int kbase = 0;
  for (int s = 0; s < 2; ++s) {
    const int src = s == 0 ? L.src0 : L.src1;
    if (src < 0) break;
    const int kseg = s == 0 ? L.k0 : L.k1;
    const float* a_base = buf[src];
    const int lda = ld[src];
    for (int k = 0; k < kseg; k += 4) {
      const long long wr = (long long)(kbase + k) * L.n_pad + t;
      const float w0 = w[wr], w1 = w[wr + L.n_pad], w2 = w[wr + 2 * L.n_pad],
                  w3 = w[wr + 3 * L.n_pad];
#pragma unroll
      for (int r = 0; r < TILE_M; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(a_base + r * lda + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
    kbase += kseg;
  }
  const float bias = B[L.b_off + t];
#pragma unroll
  for (int r = 0; r < TILE_M; ++r) emit<float>(L, buf, ld, out, row0, n, r, t, acc[r] + bias);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    mlp_fused_kernel(LayerTable tab, const T* __restrict__ pos, const T* __restrict__ dir,
                     int pos_pad, int dir_pad, const T* __restrict__ W, const float* __restrict__ B,
                     float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int ld[4] = {pos_pad + LD_PAD, dir_pad + LD_PAD, MAX_W + LD_PAD, MAX_W + LD_PAD};
  T* buf[4];
  buf[0] = reinterpret_cast<T*>(smem_raw);
  buf[1] = buf[0] + TILE_M * ld[0];
  buf[2] = buf[1] + TILE_M * ld[1];
  buf[3] = buf[2] + TILE_M * ld[2];
  float* stage = reinterpret_cast<float*>(buf[3] + TILE_M * ld[3]);

  const int row0 = blockIdx.x * TILE_M;
  for (int i = threadIdx.x; i < TILE_M * pos_pad; i += NTHREADS) {
    const int r = i / pos_pad, c = i - r * pos_pad;
    buf[BUF_POS][r * ld[0] + c] =
        row0 + r < n ? pos[(long long)(row0 + r) * pos_pad + c] : from_float<T>(0.f);
  }
  for (int i = threadIdx.x; i < TILE_M * dir_pad; i += NTHREADS) {
    const int r = i / dir_pad, c = i - r * dir_pad;
    buf[BUF_DIR][r * ld[1] + c] =
        row0 + r < n ? dir[(long long)(row0 + r) * dir_pad + c] : from_float<T>(0.f);
  }
  __syncthreads();

  for (int li = 0; li < tab.n_layers; ++li) {
    const LayerDesc L = tab.l[li];
    if constexpr (std::is_same<T, bf16>::value) {
      layer_bf16(L, buf, ld, W, B, stage, out, row0, n);
    } else {
      layer_f32(L, buf, ld, W, B, out, row0, n);
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const LayerTable& tab, const void* pos, const void* dir, int pos_pad,
                  int dir_pad, const void* w, const void* b, void* out, int n,
                  cudaStream_t stream) {
  const size_t smem = (size_t)TILE_M * (pos_pad + dir_pad + 2 * MAX_W + 4 * LD_PAD) * sizeof(T) +
                      (std::is_same<T, bf16>::value ? NWARPS * 256 * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(mlp_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TILE_M - 1) / TILE_M;
  mlp_fused_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      tab, static_cast<const T*>(pos), static_cast<const T*>(dir), pos_pad, dir_pad,
      static_cast<const T*>(w), static_cast<const float*>(b), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" {

// table: n_layers rows of DESC_FIELDS int64 values in LayerDesc order.
// is_bf16 selects the operand type of pos/dir/w; b and out are f32.
// Returns cudaGetLastError() of the launch (0 on success).
int nt_mlp_fused(int is_bf16, const void* pos, const void* dir, int pos_pad, int dir_pad,
                 const void* w, const void* b, const long long* table, int n_layers, void* out,
                 int n, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || n < 1 || pos_pad % 16 || dir_pad % 16)
    return (int)cudaErrorInvalidValue;
  LayerTable tab;
  tab.n_layers = n_layers;
  for (int i = 0; i < n_layers; ++i) {
    const long long* d = table + i * DESC_FIELDS;
    LayerDesc& L = tab.l[i];
    L.w_off = d[0];
    L.b_off = d[1];
    L.src0 = (int)d[2];
    L.k0 = (int)d[3];
    L.src1 = (int)d[4];
    L.k1 = (int)d[5];
    L.n_pad = (int)d[6];
    L.dst = (int)d[7];
    L.n_out = (int)d[8];
    L.out_col = (int)d[9];
    L.relu = (int)d[10];
    if (L.n_pad % 16 || L.n_pad > MAX_W || L.k0 % 16 || (L.src1 >= 0 && L.k1 % 16))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(tab, pos, dir, pos_pad, dir_pad, w, b, out, n, s)
                 : launch<float>(tab, pos, dir, pos_pad, dir_pad, w, b, out, n, s);
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
