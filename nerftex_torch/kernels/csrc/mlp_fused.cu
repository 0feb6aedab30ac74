// Fused ParamNerf inference forward for Hopper (sm_90a).
//
// Replaces: nerftex_tpu/kernels/mlp_pallas.py, make_fused_apply (the Pallas
// kernel built by its kernel_factory).  The chain is the 8x256 ReLU trunk
// with the [pos_map, h] skip concat, the density head, the bottleneck, the
// [dir_map, h] concat, the color layers, pre_color and the color head,
// giving out[N, 4] = (rgb logits, density).  Encodings and the parameter
// MLPs stay outside, as in the Pallas wrapper.  Layers are described by a
// small table (input segments, padded K, N, destination, ReLU), so the same
// kernel runs any ParamNerf topology with width <= 256.
//
// What bounds it on the H100: operations.  One sample costs about 1.4 MFLOP
// (699k multiply-adds) against 352 B of bf16 input and 16 B of output, far
// above the ~295 FLOP/B ridge, so the floor is the tensor-core rate
// (989 TFLOP/s bf16 dense; the f32 variant runs three TF32 products per
// multiply-add at 495 TFLOP/s, against 67 TFLOP/s for f32 FMA).
//
// bf16 variant (every frame runs it): a warp-specialised wgmma kernel.
//   * One persistent CTA per SM walks 128-sample tiles.  Two consumer
//     warpgroups own 64 rows each and run wgmma.m64nNk16 (N = the layer's
//     width, f32 accumulators in registers, 128 per thread at N = 256);
//     one producer thread streams the weights.  setmaxnreg gives the
//     consumers 232 registers and the producer warpgroup 40.
//   * Weights: pack() lays every layer out as [K/8][n_pad][8] bf16, the
//     K-major core-matrix image (8 rows x 16 bytes) that wgmma's B
//     descriptor reads without swizzle, so any slab of K rows is one
//     contiguous block.  The producer fills a ring of STAGES 32 KB stages,
//     one slab of up to 64 K rows (never straddling a layer's input
//     segments) per cp.async.bulk, guarded by full/empty mbarriers; both
//     consumers read every slab, and it is refilled once all eight consumer
//     warps have released it.  The weights are the same for every tile and
//     stay resident in L2: each tile streams all of them once (~1.4 MB).
//   * Activations: the tile's pos and dir maps sit in shared memory in the
//     same [K/8][128][8] image (no swizzle: any width that is a multiple of
//     16 fits, and a warp's 16-byte rows are contiguous), loaded by
//     cp.async and zero-filled past N; the next tile's maps are prefetched
//     once the last layer that reads them has retired.  A hidden layer's
//     output never leaves registers: the epilogue adds the bias (from
//     shared memory), applies ReLU and rounds to bf16 straight into the
//     next layer's A fragment (wgmma with A from registers), since the
//     accumulator's n8 blocks 2k and 2k+1 are exactly k16 step k's A
//     registers.  Heads write f32(bf16(y)) to the [N, 4] output.
// f32 variant (wgmma_tf32x3; the configs' default dtype): the same skeleton,
// each product split into three TF32 wgmmas with f32 accumulation,
// a_lo w_hi + a_hi w_lo + a_hi w_hi (x_hi = tf32(x), x_lo = tf32(x - x_hi);
// a_lo w_lo, ~2^-22 relative, is dropped), which keeps f32 accuracy.
//   * Weights: pack() splits every layer once into hi and lo and lays each
//     k8 block out as hi [2][n_pad][4] then lo [2][n_pad][4] (TF32 core
//     matrices, 8 rows x 4 values; TF32 takes B K-major only), so a 16-deep
//     slab of both is one contiguous 32 KB bulk copy at N = 256; three
//     stages.  Within each block of 8 K rows pack() orders the rows
//     0 2 4 6 1 3 5 7, so the A fragment's K indices l%4 and l%4 + 4 are
//     the adjacent columns 2(l%4), 2(l%4) + 1: one float2 per row from the
//     maps and exactly the accumulator's column pair from a hidden layer.
//   * Activations: a 64 x 256 f32 activation (128 registers) does not fit
//     beside the 128 accumulators, so each thread keeps its fragment of the
//     hidden activation in its own shared-memory slots (64 KB per
//     warpgroup, one float4 per k8 step, conflict-free) and splits it into
//     hi and lo as it loads it; no barrier, since a thread reads back only
//     what it wrote.  The pos and dir maps (read by at most three layers)
//     come straight from global memory, one slab ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

#define MAX_W 256
#define MAX_LAYERS 32
#define DESC_FIELDS 11

// Buffer ids; OUT_DST writes columns of the global output.
#define BUF_POS 0
#define BUF_DIR 1
#define BUF_HA 2
#define BUF_HB 3
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

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma
// ---------------------------------------------------------------------------

#define CONSUMERS 2
#define WG_THREADS 128
#define WS_THREADS (WG_THREADS * (CONSUMERS + 1))
#define TILE_ROWS (64 * CONSUMERS)
#define STAGES 4
#define SLAB_K 64
#define SLAB_STEPS (SLAB_K / 16)  // k16 steps per slab
#define STAGE_BYTES (SLAB_K * MAX_W * 2)
#define CORE_BYTES 16  // one row of an 8 x 8 bf16 core matrix
#define SMEM_LIMIT 232448

struct WsParams {
  LayerTable tab;
  const bf16* pos;
  const bf16* dir;
  const bf16* w;  // the [K/8][n_pad][8] slab image
  const float* b;
  float* out;
  int pos_pad, dir_pad, n_bias, n, n_tiles, last_in;
  unsigned off_dir, off_stage, off_bias, off_bar;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity ``parity`` to complete.  A wait that spins
// 2^24 times (far beyond any slab copy or layer) traps, so a broken ring
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, zero-filled past src_bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of one consumer warpgroup (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(WG_THREADS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: K-major core matrices of
// 8 rows x 16 bytes; lbo = byte step between core matrices along K, sbo =
// byte step between 8-row groups along M (A) or N (B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], f32 accumulators d[0 .. N/2).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] with A from registers: four bf16x2
// per thread in the m64k16 fragment layout (rows l/4 and l/4 + 8 of the
// warp's 16, columns 2(l%4) and 8 + 2(l%4)).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The slab ring as one consumer warpgroup walks it: ``it`` counts slabs,
// ``held`` the slab whose commit group is still in flight.
struct Ring {
  uint32_t stages, bars, it, held;
  bool holding;
};

// Waits for the next slab of a ring of NS stages and returns its shared
// address.
template <int NS = STAGES>
__device__ __forceinline__ uint32_t slab_begin(Ring& r) {
  const uint32_t stage = r.it % NS;
  mbar_wait(r.bars + 8 * stage, (r.it / NS) & 1);
  wgmma_fence();
  return r.stages + stage * STAGE_BYTES;
}

// Commits the slab's wgmmas; once they are in flight, the previous slab's
// group has retired (at most one pending) and that slab is released, one
// arrival per warp.
template <int N>
__device__ __forceinline__ void slab_end(Ring& r, float (&acc)[128], int lane) {
  wgmma_commit();
  fence_acc<N>(acc);
  if (r.holding) {
    wgmma_wait<1>();
    if (lane == 0) mbar_arrive(r.bars + 8 * (STAGES + r.held));
  }
  r.held = r.it % STAGES;
  r.holding = true;
  ++r.it;
}

// The K loop of one layer for one consumer warpgroup: first the segment in
// shared memory (pos or dir map, ``smem_steps`` k16 steps from ``a_smem``),
// then the hidden segment from registers (``h_steps`` steps of ``h``), each
// in slabs of up to SLAB_STEPS steps from the ring.  The register loop is
// unrolled so ``h`` keeps constant indices.
template <int N>
__device__ __forceinline__ void mma_layer(float (&acc)[128], const uint32_t (&h)[64],
                                          const LayerDesc& L, uint32_t a_smem, int smem_steps,
                                          int h_steps, Ring& ring, int lane) {
  const uint32_t lbo_b = L.n_pad * CORE_BYTES;
  const uint32_t a_step = 2 * TILE_ROWS * CORE_BYTES;  // one k16 step of A
  int k = 0;
  for (int q = 0; q < smem_steps; q += SLAB_STEPS) {
    const uint32_t b = slab_begin(ring);
    fence_acc<N>(acc);
    const int qe = min(smem_steps, q + SLAB_STEPS);
    for (int s = q; s < qe; ++s, ++k)
      wgmma<N>(acc, desc(a_smem + s * a_step, TILE_ROWS * CORE_BYTES, 8 * CORE_BYTES),
               desc(b + (s - q) * 2 * lbo_b, lbo_b, 8 * CORE_BYTES), k > 0);
    slab_end<N>(ring, acc, lane);
  }
#pragma unroll
  for (int q = 0; q < MAX_W / 16; q += SLAB_STEPS) {
    if (q < h_steps) {
      const uint32_t b = slab_begin(ring);
      fence_acc<N>(acc);
#pragma unroll
      for (int s = q; s < q + SLAB_STEPS; ++s) {
        if (s < h_steps) {
          wgmma_rs<N>(acc, h[4 * s], h[4 * s + 1], h[4 * s + 2], h[4 * s + 3],
                      desc(b + (s - q) * 2 * lbo_b, lbo_b, 8 * CORE_BYTES), k > 0);
          ++k;
        }
      }
      slab_end<N>(ring, acc, lane);
    }
  }
  wgmma_wait<0>();
  fence_acc<N>(acc);
  if (lane == 0) mbar_arrive(ring.bars + 8 * (STAGES + ring.held));
  ring.holding = false;
}

// Bias, ReLU and bf16 rounding of the accumulator fragment: thread (warp w,
// lane l) holds rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1).  A hidden
// layer's output stays in registers as the next layer's A fragment (the
// accumulator's n8 blocks 2k, 2k+1 are exactly k16 step k's A registers);
// a head writes f32(bf16(y)) to its output columns.
template <int N>
__device__ __forceinline__ void epilogue(float (&acc)[128], uint32_t (&h)[64], const LayerDesc& L,
                                         const float* bias, float* out, int wg, int warp,
                                         int lane, int row0, int n) {
  const int r = wg * 64 + warp * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  const float* b = bias + L.b_off;
  if (L.dst >= 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j < L.n_pad) {
        const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j + c);
        float v0 = acc[4 * j] + bj.x, v1 = acc[4 * j + 1] + bj.y;
        float v2 = acc[4 * j + 2] + bj.x, v3 = acc[4 * j + 3] + bj.y;
        if (L.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f);
          v3 = fmaxf(v3, 0.f);
        }
        h[2 * j] = pack_bf16(v0, v1);
        h[2 * j + 1] = pack_bf16(v2, v3);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        const int row = row0 + r + 8 * (e >> 1);
        if (col < L.n_out && row < n) {
          float y = acc[4 * j + e] + b[col];
          if (L.relu) y = fmaxf(y, 0.f);
          out[(long long)row * 4 + L.out_col + col] = __bfloat162float(__float2bfloat16_rn(y));
        }
      }
    }
  }
}

// cp.async of one warpgroup's 64 rows of a tile's pos and dir maps into the
// [K/8][128][8] image; rows past n are zero-filled.
__device__ __forceinline__ void load_inputs(const WsParams& p, int tile, int wg, int t,
                                            uint32_t s_pos, uint32_t s_dir) {
  const int row0 = tile * TILE_ROWS + wg * 64;
  for (int s = 0; s < 2; ++s) {
    const bf16* src = s == 0 ? p.pos : p.dir;
    const int width = s == 0 ? p.pos_pad : p.dir_pad;
    const uint32_t dst = s == 0 ? s_pos : s_dir;
    for (int i = t; i < 64 * (width / 8); i += WG_THREADS) {
      const int g = i >> 6, r = i & 63, row = row0 + r;
      cp_async16(dst + (g * TILE_ROWS + wg * 64 + r) * CORE_BYTES,
                 src + (long long)min(row, p.n - 1) * width + g * 8, row < p.n ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(WS_THREADS, 1)
    mlp_wgmma_kernel(const __grid_constant__ WsParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, t = tid % WG_THREADS;
  const int warp = t / 32, lane = t % 32;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + p.off_bar;  // full[STAGES], then empty[STAGES]
  float* bias = reinterpret_cast<float*>(smem + p.off_bias);
  for (int i = tid; i < p.n_bias; i += WS_THREADS) bias[i] = p.b[i];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread walks every tile's layers, segments and slabs in
    // the consumers' order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int li = 0; li < p.tab.n_layers; ++li) {
          const LayerDesc& L = p.tab.l[li];
          const int k = L.k0 + (L.src1 >= 0 ? L.k1 : 0);
          for (int k0 = 0; k0 < k; ++it) {
            const int seg_end = k0 < L.k0 ? L.k0 : k;  // slabs never straddle segments
            const int depth = min(SLAB_K, seg_end - k0);
            const uint32_t stage = it % STAGES;
            mbar_wait(bars + 8 * (STAGES + stage), ((it / STAGES) & 1) ^ 1);
            const uint32_t bytes = depth * L.n_pad * 2;
            mbar_expect_tx(bars + 8 * stage, bytes);
            bulk_copy(base + p.off_stage + stage * STAGE_BYTES,
                      p.w + L.w_off + (long long)k0 * L.n_pad, bytes, bars + 8 * stage);
            k0 += depth;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const uint32_t s_pos = base, s_dir = base + p.off_dir;
    float acc[128];
    uint32_t h[64];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) h[i] = 0u;
    Ring ring = {base + p.off_stage, bars, 0u, 0u, false};
    load_inputs(p, blockIdx.x, wg, t, s_pos, s_dir);
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int row0 = tile * TILE_ROWS;
      cp_async_wait_all();
      fence_proxy_async();
      wg_sync(wg);
      for (int li = 0; li < p.tab.n_layers; ++li) {
        const LayerDesc L = p.tab.l[li];
        const int n_inst = L.n_pad <= 16 ? 16 : L.n_pad <= 32 ? 32 : L.n_pad <= 64 ? 64
                                              : L.n_pad <= 128 ? 128 : 256;
        // The table check puts a pos/dir segment first and the hidden one last.
        const bool in_smem = L.src0 == BUF_POS || L.src0 == BUF_DIR;
        const uint32_t a_smem = (L.src0 == BUF_DIR ? s_dir : s_pos) + wg * 64 * CORE_BYTES;
        const int smem_steps = in_smem ? L.k0 / 16 : 0;
        const int h_steps = (in_smem ? (L.src1 >= 0 ? L.k1 : 0) : L.k0) / 16;
        switch (n_inst) {
          case 16: mma_layer<16>(acc, h, L, a_smem, smem_steps, h_steps, ring, lane); break;
          case 32: mma_layer<32>(acc, h, L, a_smem, smem_steps, h_steps, ring, lane); break;
          case 64: mma_layer<64>(acc, h, L, a_smem, smem_steps, h_steps, ring, lane); break;
          case 128: mma_layer<128>(acc, h, L, a_smem, smem_steps, h_steps, ring, lane); break;
          default: mma_layer<256>(acc, h, L, a_smem, smem_steps, h_steps, ring, lane); break;
        }
        if (li == p.last_in) {
          // Every read of this tile's pos/dir maps has retired.
          wg_sync(wg);
          if (tile + (int)gridDim.x < p.n_tiles)
            load_inputs(p, tile + gridDim.x, wg, t, s_pos, s_dir);
        }
        switch (n_inst) {
          case 16: epilogue<16>(acc, h, L, bias, p.out, wg, warp, lane, row0, p.n); break;
          case 32: epilogue<32>(acc, h, L, bias, p.out, wg, warp, lane, row0, p.n); break;
          case 64: epilogue<64>(acc, h, L, bias, p.out, wg, warp, lane, row0, p.n); break;
          case 128: epilogue<128>(acc, h, L, bias, p.out, wg, warp, lane, row0, p.n); break;
          default: epilogue<256>(acc, h, L, bias, p.out, wg, warp, lane, row0, p.n); break;
        }
      }
    }
  }
}

// Both kernels keep one hidden activation (bf16: in registers, f32: in each
// thread's shared-memory slots): every layer reads at most one pos/dir
// segment, first, and the latest hidden output at its full width, last.
// Returns the last layer that reads pos or dir, or -1 if the table does not
// fit.
static int check_table(const LayerTable& tab) {
  int cur = -1, cur_width = 0, last_in = -1;
  for (int i = 0; i < tab.n_layers; ++i) {
    const LayerDesc& L = tab.l[i];
    const bool in_smem = L.src0 == BUF_POS || L.src0 == BUF_DIR;
    const int hid = in_smem ? L.src1 : L.src0;
    const int hid_k = in_smem ? L.k1 : L.k0;
    if (in_smem) last_in = i;
    if (!in_smem && L.src1 >= 0) return -1;
    if (hid >= 0 && (hid != cur || hid_k != cur_width)) return -1;
    if (L.dst >= 0) {
      if (L.dst != BUF_HA && L.dst != BUF_HB) return -1;
      cur = L.dst;
      cur_width = L.n_pad;
    }
  }
  return last_in;
}

static int launch_bf16(const LayerTable& tab, const void* pos, const void* dir, int pos_pad,
                       int dir_pad, const void* w, const void* b, void* out, int n,
                       cudaStream_t stream) {
  WsParams p;
  p.tab = tab;
  p.pos = static_cast<const bf16*>(pos);
  p.dir = static_cast<const bf16*>(dir);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<float*>(out);
  p.pos_pad = pos_pad;
  p.dir_pad = dir_pad;
  p.n = n;
  p.n_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  p.last_in = check_table(tab);
  if (p.last_in < 0 || (reinterpret_cast<uintptr_t>(w) & 15)) return (int)cudaErrorInvalidValue;
  p.n_bias = 0;
  for (int i = 0; i < tab.n_layers; ++i)
    p.n_bias = std::max(p.n_bias, (int)(tab.l[i].b_off + tab.l[i].n_pad));
  p.off_dir = TILE_ROWS * pos_pad * 2;
  p.off_stage = p.off_dir + TILE_ROWS * dir_pad * 2;
  p.off_bias = p.off_stage + STAGES * STAGE_BYTES;
  p.off_bar = p.off_bias + ((p.n_bias * 4 + 15) & ~15);
  const int smem = p.off_bar + 2 * STAGES * 8;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static int sms = 0, smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(mlp_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    smem_set = SMEM_LIMIT;
  }
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int grid = std::min(p.n_tiles, sms);
  mlp_wgmma_kernel<<<grid, WS_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 wgmma
// ---------------------------------------------------------------------------

#define T_STAGES 3
#define T_SLAB_K 16                                // K rows per slab
#define T_STEPS (T_SLAB_K / 8)                     // k8 steps per slab
#define T_STAGE_BYTES (T_SLAB_K * MAX_W * 4 * 2)   // 32 KB: hi and lo of one slab at N = 256
#define T_HID_BYTES (MAX_W / 8 * WG_THREADS * 16)  // 64 KB: one warpgroup's hidden activation
#define T_OFF_STAGE (CONSUMERS * T_HID_BYTES)
#define T_OFF_BAR (T_OFF_STAGE + T_STAGES * T_STAGE_BYTES)
#define T_SMEM (T_OFF_BAR + 2 * T_STAGES * 8)
static_assert(T_STAGE_BYTES == STAGE_BYTES, "slab_begin steps by STAGE_BYTES");
static_assert(T_SMEM <= SMEM_LIMIT, "3xTF32 kernel's shared memory");

struct TfParams {
  LayerTable tab;
  const float* pos;
  const float* dir;
  const float* w;  // the tf32 hi/lo image (PackedMLP.tf32_slabs)
  const float* b;
  float* out;
  int pos_pad, dir_pad, n, n_tiles;
};

// D[64 x N] (+)= A[64 x 8] B[8 x N] in tf32 with A from registers: a[0..3]
// hold rows l/4, l/4 + 8, l/4, l/4 + 8 of the warp's 16 at K indices l%4,
// l%4, l%4 + 4, l%4 + 4 (the m64k8 tf32 fragment).  TF32 takes both
// operands K-major, so there is no transpose flag.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<256>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// x = hi + lo + O(2^-22 |x|): hi is x rounded to tf32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32), lo the rounded remainder (x - hi is
// exact).  Integer arithmetic on the bits, so pack() in Python splits the
// weights by the same rule, bit for bit.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32(const float4& x, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_rna(__float_as_uint(v[e]));
    lo[e] = tf32_rna(__float_as_uint(v[e] - __uint_as_float(hi[e])));
  }
}

// Pins a register's definition before the next asm statement (wgmma.fence).
__device__ __forceinline__ void fence_reg(uint32_t (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[e])::"memory");
}

// One slab (two k8 steps) of a layer: x[s] is step s's A fragment in f32,
// b the slab's stage, where k8 block s holds the hi core matrices (two, lbo
// apart) and then the lo ones.  Three products per step, the small ones
// first; the layer's first product starts the accumulator.  The slab's six
// wgmmas retire before it returns (its stage is released at once), and the
// other consumer warpgroup keeps the tensor cores busy meanwhile: leaving
// them in flight while the next slab's fragments are split, as the bf16
// kernel does, makes ptxas serialise every wgmma (C7512), which is slower
// (scripts/probe_mlp_tf32.py, "pipelined").
template <int N>
__device__ __forceinline__ void tf32_slab(float (&acc)[128], const float4 (&x)[T_STEPS],
                                          uint32_t lbo, Ring& ring, int lane, int& k) {
  uint32_t hi[T_STEPS][4], lo[T_STEPS][4];
#pragma unroll
  for (int s = 0; s < T_STEPS; ++s) {
    split_tf32(x[s], hi[s], lo[s]);
    fence_reg(hi[s]);
    fence_reg(lo[s]);
  }
  const uint32_t b = slab_begin<T_STAGES>(ring);
  fence_acc<N>(acc);
#pragma unroll
  for (int s = 0; s < T_STEPS; ++s, ++k) {
    const uint32_t b_hi = b + s * 4 * lbo, b_lo = b_hi + 2 * lbo;
    wgmma_tf32<N>(acc, lo[s], desc(b_hi, lbo, 8 * CORE_BYTES), k > 0);
    wgmma_tf32<N>(acc, hi[s], desc(b_lo, lbo, 8 * CORE_BYTES), 1);
    wgmma_tf32<N>(acc, hi[s], desc(b_hi, lbo, 8 * CORE_BYTES), 1);
  }
  wgmma_commit();
  fence_acc<N>(acc);
  wgmma_wait<0>();
  fence_acc<N>(acc);
  if (lane == 0) mbar_arrive(ring.bars + 8 * (T_STAGES + ring.it % T_STAGES));
  ++ring.it;
}

// A fragments of one slab of a pos/dir map, straight from global memory:
// rows g0 and g1 (the thread's two), columns col + 8s + 2(l%4) and + 1,
// which pack() made K indices l%4 and l%4 + 4 of step s.
__device__ __forceinline__ void load_map(float4 (&x)[T_STEPS], const float* g0, const float* g1,
                                         int col) {
#pragma unroll
  for (int s = 0; s < T_STEPS; ++s) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(g0 + col + 8 * s));
    const float2 c = __ldg(reinterpret_cast<const float2*>(g1 + col + 8 * s));
    x[s] = make_float4(a.x, c.x, a.y, c.y);
  }
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

// The K loop of one layer for one consumer warpgroup: a pos/dir segment
// from global memory (the next slab's fragments loaded while this one
// multiplies), then the hidden segment from the thread's own slots in
// shared memory (s_hid: step s at s_hid + s * WG_THREADS * 16).
template <int N>
__device__ __forceinline__ void tf32_layer(float (&acc)[128], const LayerDesc& L, const TfParams& p,
                                           uint32_t s_hid, int r0, int r1, Ring& ring, int lane) {
  const uint32_t lbo = L.n_pad * CORE_BYTES;
  const int c = 2 * (lane % 4);
  int k = 0;
  float4 x[T_STEPS];
  for (int seg = 0; seg < 2; ++seg) {
    const int src = seg == 0 ? L.src0 : L.src1;
    if (src < 0) break;
    const int slabs = (seg == 0 ? L.k0 : L.k1) / T_SLAB_K;
    if (src == BUF_POS || src == BUF_DIR) {
      const int width = src == BUF_POS ? p.pos_pad : p.dir_pad;
      const float* map = src == BUF_POS ? p.pos : p.dir;
      const float* g0 = map + (long long)r0 * width + c;
      const float* g1 = map + (long long)r1 * width + c;
      float4 next[T_STEPS];
      load_map(next, g0, g1, 0);
      for (int q = 0; q < slabs; ++q) {
#pragma unroll
        for (int s = 0; s < T_STEPS; ++s) x[s] = next[s];
        if (q + 1 < slabs) load_map(next, g0, g1, (q + 1) * T_SLAB_K);
        tf32_slab<N>(acc, x, lbo, ring, lane, k);
      }
    } else {
      for (int q = 0; q < slabs; ++q) {
#pragma unroll
        for (int s = 0; s < T_STEPS; ++s)
          x[s] = ld_shared4(s_hid + (T_STEPS * q + s) * WG_THREADS * 16);
        tf32_slab<N>(acc, x, lbo, ring, lane, k);
      }
    }
  }
}

// Bias and ReLU of the accumulator fragment (rows r, r + 8 of the thread,
// columns 8j + 2(l%4) and + 1).  A hidden layer's output goes to the
// thread's own shared-memory slots, one float4 per k8 step in A-fragment
// order, so the next layer reads back exactly what this thread wrote (no
// barrier); a head writes f32 to its output columns.
template <int N>
__device__ __forceinline__ void tf32_epilogue(const float (&acc)[128], const LayerDesc& L,
                                              const TfParams& p, uint32_t s_hid, int lane, int r) {
  const int c = 2 * (lane % 4);
  const float* b = p.b + L.b_off;
  if (L.dst >= 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j < L.n_pad) {
        const float2 bj = __ldg(reinterpret_cast<const float2*>(b + 8 * j + c));
        float v0 = acc[4 * j] + bj.x, v1 = acc[4 * j + 1] + bj.y;
        float v2 = acc[4 * j + 2] + bj.x, v3 = acc[4 * j + 3] + bj.y;
        if (L.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f);
          v3 = fmaxf(v3, 0.f);
        }
        st_shared4(s_hid + j * WG_THREADS * 16, v0, v2, v1, v3);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        const int row = r + 8 * (e >> 1);
        if (col < L.n_out && row < p.n) {
          float y = acc[4 * j + e] + __ldg(b + col);
          if (L.relu) y = fmaxf(y, 0.f);
          p.out[(long long)row * 4 + L.out_col + col] = y;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(WS_THREADS, 1)
    mlp_tf32_kernel(const __grid_constant__ TfParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, t = tid % WG_THREADS;
  const int warp = t / 32, lane = t % 32;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + T_OFF_BAR;  // full[T_STAGES], then empty[T_STAGES]
  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (T_STAGES + s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread streams every tile's layers in 16-deep slabs of
    // hi and lo weights, in the consumers' order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int li = 0; li < p.tab.n_layers; ++li) {
          const LayerDesc& L = p.tab.l[li];
          const int k = L.k0 + (L.src1 >= 0 ? L.k1 : 0);
          for (int k0 = 0; k0 < k; k0 += T_SLAB_K, ++it) {
            const uint32_t stage = it % T_STAGES;
            mbar_wait(bars + 8 * (T_STAGES + stage), ((it / T_STAGES) & 1) ^ 1);
            const uint32_t bytes = T_SLAB_K * L.n_pad * 8;
            mbar_expect_tx(bars + 8 * stage, bytes);
            bulk_copy(base + T_OFF_STAGE + stage * T_STAGE_BYTES,
                      p.w + 2 * (L.w_off + (long long)k0 * L.n_pad), bytes, bars + 8 * stage);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const uint32_t s_hid = base + wg * T_HID_BYTES + t * 16;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    Ring ring = {base + T_OFF_STAGE, bars, 0u, 0u, false};
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int r = tile * TILE_ROWS + wg * 64 + warp * 16 + lane / 4;
      const int r0 = min(r, p.n - 1), r1 = min(r + 8, p.n - 1);
      for (int li = 0; li < p.tab.n_layers; ++li) {
        const LayerDesc L = p.tab.l[li];
        const int n_inst = L.n_pad <= 16 ? 16 : L.n_pad <= 32 ? 32 : L.n_pad <= 64 ? 64
                                              : L.n_pad <= 128 ? 128 : 256;
        switch (n_inst) {
          case 16:
            tf32_layer<16>(acc, L, p, s_hid, r0, r1, ring, lane);
            tf32_epilogue<16>(acc, L, p, s_hid, lane, r);
            break;
          case 32:
            tf32_layer<32>(acc, L, p, s_hid, r0, r1, ring, lane);
            tf32_epilogue<32>(acc, L, p, s_hid, lane, r);
            break;
          case 64:
            tf32_layer<64>(acc, L, p, s_hid, r0, r1, ring, lane);
            tf32_epilogue<64>(acc, L, p, s_hid, lane, r);
            break;
          case 128:
            tf32_layer<128>(acc, L, p, s_hid, r0, r1, ring, lane);
            tf32_epilogue<128>(acc, L, p, s_hid, lane, r);
            break;
          default:
            tf32_layer<256>(acc, L, p, s_hid, r0, r1, ring, lane);
            tf32_epilogue<256>(acc, L, p, s_hid, lane, r);
            break;
        }
      }
    }
  }
}

static int launch_tf32(const LayerTable& tab, const void* pos, const void* dir, int pos_pad,
                       int dir_pad, const void* w, const void* b, void* out, int n,
                       cudaStream_t stream) {
  TfParams p;
  p.tab = tab;
  p.pos = static_cast<const float*>(pos);
  p.dir = static_cast<const float*>(dir);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<float*>(out);
  p.pos_pad = pos_pad;
  p.dir_pad = dir_pad;
  p.n = n;
  p.n_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  if (check_table(tab) < 0 || (reinterpret_cast<uintptr_t>(w) & 15) ||
      (reinterpret_cast<uintptr_t>(pos) & 7) || (reinterpret_cast<uintptr_t>(dir) & 7) ||
      (reinterpret_cast<uintptr_t>(b) & 7))
    return (int)cudaErrorInvalidValue;
  static int sms = 0, smem_set = 0;
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(mlp_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = 1;
  }
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int grid = std::min(p.n_tiles, sms);
  mlp_tf32_kernel<<<grid, WS_THREADS, T_SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

// table: n_layers rows of DESC_FIELDS int64 values in LayerDesc order.
// is_bf16 selects the variant: pos/dir bf16 and w the [K/8][n_pad][8] slab
// image (wgmma_bf16), or pos/dir f32 and w the tf32 hi/lo image
// (wgmma_tf32x3); b and out are f32.  Returns cudaGetLastError() of the launch (0 on
// success).
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
  return is_bf16 ? launch_bf16(tab, pos, dir, pos_pad, dir_pad, w, b, out, n, s)
                 : launch_tf32(tab, pos, dir, pos_pad, dir_pad, w, b, out, n, s);
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
