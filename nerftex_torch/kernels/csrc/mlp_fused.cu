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
// (989 TFLOP/s bf16 dense; 67 TFLOP/s for the f32 FMA variant).
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
// f32 variant: plain FMA, one output column per thread, TILE_M = 64 rows per
// block, every activation in shared memory (no frame runs it).

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

// Waits for the next slab and returns its shared address.
__device__ __forceinline__ uint32_t slab_begin(Ring& r) {
  const uint32_t stage = r.it % STAGES;
  mbar_wait(r.bars + 8 * stage, (r.it / STAGES) & 1);
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

// The kernel keeps one hidden activation, in registers: every layer reads
// at most one pos/dir segment, first, and the latest hidden output at its
// full width, last.  Returns the last layer that reads pos or dir, or -1 if
// the table does not fit.
static int check_bf16_table(const LayerTable& tab) {
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
  p.last_in = check_bf16_table(tab);
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
// f32: plain FMA
// ---------------------------------------------------------------------------

#define TILE_M 64
#define NTHREADS 256
#define LD_PAD 8

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
  for (int r = 0; r < TILE_M; ++r) {
    float y = acc[r] + bias;
    if (L.relu) y = fmaxf(y, 0.f);
    if (L.dst >= 0) {
      buf[L.dst][r * ld[L.dst] + t] = y;
    } else if (t < L.n_out && row0 + r < n) {
      out[(long long)(row0 + r) * 4 + L.out_col + t] = y;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
    mlp_f32_kernel(LayerTable tab, const float* __restrict__ pos, const float* __restrict__ dir,
                   int pos_pad, int dir_pad, const float* __restrict__ W,
                   const float* __restrict__ B, float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int ld[4] = {pos_pad + LD_PAD, dir_pad + LD_PAD, MAX_W + LD_PAD, MAX_W + LD_PAD};
  float* buf[4];
  buf[0] = reinterpret_cast<float*>(smem_raw);
  buf[1] = buf[0] + TILE_M * ld[0];
  buf[2] = buf[1] + TILE_M * ld[1];
  buf[3] = buf[2] + TILE_M * ld[2];

  const int row0 = blockIdx.x * TILE_M;
  for (int i = threadIdx.x; i < TILE_M * pos_pad; i += NTHREADS) {
    const int r = i / pos_pad, c = i - r * pos_pad;
    buf[BUF_POS][r * ld[0] + c] = row0 + r < n ? pos[(long long)(row0 + r) * pos_pad + c] : 0.f;
  }
  for (int i = threadIdx.x; i < TILE_M * dir_pad; i += NTHREADS) {
    const int r = i / dir_pad, c = i - r * dir_pad;
    buf[BUF_DIR][r * ld[1] + c] = row0 + r < n ? dir[(long long)(row0 + r) * dir_pad + c] : 0.f;
  }
  __syncthreads();

  for (int li = 0; li < tab.n_layers; ++li) {
    const LayerDesc L = tab.l[li];
    layer_f32(L, buf, ld, W, B, out, row0, n);
    __syncthreads();
  }
}

static int launch_f32(const LayerTable& tab, const void* pos, const void* dir, int pos_pad,
                      int dir_pad, const void* w, const void* b, void* out, int n,
                      cudaStream_t stream) {
  const size_t smem = (size_t)TILE_M * (pos_pad + dir_pad + 2 * MAX_W + 4 * LD_PAD) * sizeof(float);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(mlp_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int grid = (n + TILE_M - 1) / TILE_M;
  mlp_f32_kernel<<<grid, NTHREADS, smem, stream>>>(
      tab, static_cast<const float*>(pos), static_cast<const float*>(dir), pos_pad, dir_pad,
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" {

// table: n_layers rows of DESC_FIELDS int64 values in LayerDesc order.
// is_bf16 selects the variant: pos/dir bf16 and w the [K/8][n_pad][8] slab
// image (wgmma), or pos/dir/w f32 with w row-major [K_pad, n_pad] (FMA);
// b and out are f32.  Returns cudaGetLastError() of the launch (0 on
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
                 : launch_f32(tab, pos, dir, pos_pad, dir_pad, w, b, out, n, s);
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
