// The shadow query: whether anything blocks each point toward its light, for
// Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  It replaces the eager chain of
// nerftex_tpu/instancing/device.py:2180 _shadow_query, which XLA fuses into
// one any-reduction on the TPU and which PyTorch runs as about 130
// elementwise launches over [points, columns] planes per chunk of points
// (kernels/shadow_query.py shadow_query_plain, the chain as it was).
//
// What it computes, for each point p [3] with its light direction l [3], over
// the candidate columns (every column, or the gathered ids; a column whose
// valid flag is false never blocks):
//   instance n (world-to-local rows R_c, translation T_c): o_c = R_c . p +
//     T_c, d_c = R_c . l, with a . b = (a0 b0 + a1 b1) + a2 b2.  Blocked if
//     |d_z| > 1e-12 and the ray o + t d crosses the top face (z = b_1z) with
//     d_z < 0 or the bottom face (z = b_0z), with t = (z - o_z) / d_z in
//     (0, T_FAR) and o_x + t d_x in [b_0x, b_1x], o_y + t d_y in [b_0y, b_1y];
//   triangle n (v0, e1, e2, geometric normal ng): Moller-Trumbore from p
//     along l (|det| > 1e-12, u >= 0, v >= 0, u + v <= 1, 1e-6 < t < T_FAR)
//     on a front face only (l . ng < 0).
// Output: one byte per point, 1 where blocked.
//
// What bounds it on the H100.  Operations: a block's query is up to 65,536
// points x 5,318 columns, about 60 float operations a test, and its data is
// about 2 MB; so it is bound by the f32 pipes (33.5 T unfused operations a
// second), never by bytes.  What the design does about that:
//  - no [points, columns] value leaves registers, and the any-reduction is a
//    flag per thread;
//  - a point stops at its first blocking column, and a CTA stops loading
//    columns once every point it holds is blocked (__syncthreads_and); the
//    32 points of a ray lie side by side, so a warp's points are shadowed
//    alike and leave together;
//  - each test leaves at the first of its conditions that fails, cheapest
//    first: a triangle's front-face test (five operations; half of a closed
//    mesh, and most of a terrain lit from above, fail it), a box's |d_z| and
//    the sign of (z - o_z) against d_z (t > 0 needs them alike), before any
//    division.  Every condition is one of the conjunction's own terms, so the
//    answer is the chain's.
//
// Design.  One thread per point, kThreads points a CTA.  Columns are staged
// in shared memory kThreads at a time (one per thread, gathered by id, 48
// bytes as three float4: a box's rows with their translation, a triangle's
// {ng, v0x}, {e2, v0y}, {e1, v0z}); every thread walks the tile, the warp
// reading each column as a broadcast.  A padding column is staged as zeros,
// which no test passes (d_z and l . ng are then 0 or NaN).  Boxes come first:
// they block most of the shadowed points of the shipped scenes.  One launch
// answers a whole block's points: no chunking.
//
// Rounding: every multiply, add, subtract and divide is its own
// round-to-nearest intrinsic (nvcc never contracts these into an fma), in
// the plain chain's order, with its constants
// rounded from the same doubles; the reciprocal 1 / det is correctly rounded
// as PyTorch's is.  So the result is bit-equal to shadow_query_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // points a CTA, columns a tile (best of 64-512)
constexpr float kTFar = (float)100.0;    // T_FAR
constexpr float kDetEps = (float)1e-12;  // |det| and |d_z| floor
constexpr float kTMin = (float)1e-6;     // a triangle hit's least t

struct Box {
  float x0, y0, z0, x1, y1, z1;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (a0 b0 + a1 b1) + a2 b2, each operation rounded on its own.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// One face of a box: the crossing at t = num / dz inside (0, T_FAR) and
// inside the face's x and y bounds.
__device__ __forceinline__ bool face(float num, float dz, float ox, float oy, float dx, float dy,
                                     const Box& b) {
  const float t = __fdiv_rn(num, dz);
  if (!(t > 0.f && t < kTFar)) return false;
  const float px = add(ox, mul(t, dx));
  const float py = add(oy, mul(t, dy));
  return px >= b.x0 && px <= b.x1 && py >= b.y0 && py <= b.y1;
}

// col: {R_0, T_0}, {R_1, T_1}, {R_2, T_2}.
__device__ __forceinline__ bool box_blocks(const float4* col, float px, float py, float pz,
                                           float lx, float ly, float lz, const Box& b) {
  const float4 r2 = col[2];
  const float dz = dot3(lx, ly, lz, r2.x, r2.y, r2.z);
  if (!(fabsf(dz) > kDetEps)) return false;  // then the chain's safe_dz is dz
  const float oz = add(dot3(px, py, pz, r2.x, r2.y, r2.z), r2.w);
  const float n_top = sub(b.z1, oz);
  const float n_bot = sub(b.z0, oz);
  // t = n / dz > 0 needs n nonzero and of dz's sign.
  const bool top = dz < 0.f && n_top < 0.f;
  const bool bot = dz > 0.f ? n_bot > 0.f : n_bot < 0.f;
  if (!(top || bot)) return false;
  const float4 r0 = col[0];
  const float4 r1 = col[1];
  const float ox = add(dot3(px, py, pz, r0.x, r0.y, r0.z), r0.w);
  const float oy = add(dot3(px, py, pz, r1.x, r1.y, r1.z), r1.w);
  const float dx = dot3(lx, ly, lz, r0.x, r0.y, r0.z);
  const float dy = dot3(lx, ly, lz, r1.x, r1.y, r1.z);
  return (top && face(n_top, dz, ox, oy, dx, dy, b)) ||
         (bot && face(n_bot, dz, ox, oy, dx, dy, b));
}

// col: {ng, v0x}, {e2, v0y}, {e1, v0z}.
__device__ __forceinline__ bool tri_blocks(const float4* col, float px, float py, float pz,
                                           float lx, float ly, float lz) {
  const float4 a = col[0];
  if (!(dot3(lx, ly, lz, a.x, a.y, a.z) < 0.f)) return false;  // front faces only
  const float4 e2 = col[1];
  const float4 e1 = col[2];
  const float pvx = sub(mul(ly, e2.z), mul(lz, e2.y));
  const float pvy = sub(mul(lz, e2.x), mul(lx, e2.z));
  const float pvz = sub(mul(lx, e2.y), mul(ly, e2.x));
  const float det = dot3(e1.x, e1.y, e1.z, pvx, pvy, pvz);
  if (!(fabsf(det) > kDetEps)) return false;
  const float inv_det = __frcp_rn(det);
  const float tx = sub(px, a.w);
  const float ty = sub(py, e2.w);
  const float tz = sub(pz, e1.w);
  const float u = mul(dot3(tx, ty, tz, pvx, pvy, pvz), inv_det);
  if (!(u >= 0.f)) return false;
  const float qx = sub(mul(ty, e1.z), mul(tz, e1.y));
  const float qy = sub(mul(tz, e1.x), mul(tx, e1.z));
  const float qz = sub(mul(tx, e1.y), mul(ty, e1.x));
  const float v = mul(dot3(lx, ly, lz, qx, qy, qz), inv_det);
  if (!(v >= 0.f && add(u, v) <= 1.f)) return false;
  const float t = mul(dot3(e2.x, e2.y, e2.z, qx, qy, qz), inv_det);
  return t > kTMin && t < kTFar;
}

struct Columns {
  const int64_t* ids;   // [n] candidate ids, or null for 0 .. n - 1
  const bool* valid;    // [n] or null (all valid)
  int n;
};

// Column j of the boxes or the triangles into dst[0 .. 2] (zeros if padding).
template <bool kBoxes>
__device__ __forceinline__ void stage(float4* dst, const Columns& cols, int j, const float* a,
                                      const float* b, const float* c, const float* d) {
  float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c0 = z, c1 = z, c2 = z;
  if (!cols.valid || cols.valid[j]) {
    const int64_t id = cols.ids ? cols.ids[j] : j;
    if (kBoxes) {  // a: inv_rot [N, 3, 3], b: inv_trans [N, 3]
      const float* r = a + id * 9;
      const float* t = b + id * 3;
      c0 = make_float4(r[0], r[1], r[2], t[0]);
      c1 = make_float4(r[3], r[4], r[5], t[1]);
      c2 = make_float4(r[6], r[7], r[8], t[2]);
    } else {  // a: v0, b: e1, c: e2, d: ng, each [T, 3]
      const float* v0 = a + id * 3;
      const float* e1 = b + id * 3;
      const float* e2 = c + id * 3;
      const float* ng = d + id * 3;
      c0 = make_float4(ng[0], ng[1], ng[2], v0[0]);
      c1 = make_float4(e2[0], e2[1], e2[2], v0[1]);
      c2 = make_float4(e1[0], e1[1], e1[2], v0[2]);
    }
  }
  dst[0] = c0;
  dst[1] = c1;
  dst[2] = c2;
}

// Walk every tile of one kind of column; returns the point's flag.  Every
// thread of the CTA calls it (the barriers), live or not.
template <bool kBoxes>
__device__ bool walk(float4* tile, bool blocked, bool live, const Columns& cols, const float* a,
                     const float* b, const float* c, const float* d, float px, float py, float pz,
                     float lx, float ly, float lz, const Box& box) {
  for (int base = 0; base < cols.n; base += kThreads) {
    // Also the barrier after the previous tile's last read.
    if (__syncthreads_and(blocked || !live)) break;
    const int count = min(kThreads, cols.n - base);
    if ((int)threadIdx.x < count) {
      stage<kBoxes>(tile + 3 * threadIdx.x, cols, base + threadIdx.x, a, b, c, d);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < count && !blocked; ++j) {
        blocked = kBoxes ? box_blocks(tile + 3 * j, px, py, pz, lx, ly, lz, box)
                         : tri_blocks(tile + 3 * j, px, py, pz, lx, ly, lz);
      }
    }
  }
  return blocked;
}

__global__ void __launch_bounds__(kThreads)
shadow_query_kernel(const float* __restrict__ pts, const float* __restrict__ light, int m,
                    const float* __restrict__ inv_rot, const float* __restrict__ inv_trans,
                    Columns boxes, const float* __restrict__ v0, const float* __restrict__ e1,
                    const float* __restrict__ e2, const float* __restrict__ ng, Columns tris,
                    const float* __restrict__ b_0, const float* __restrict__ b_1,
                    unsigned char* __restrict__ out) {
  __shared__ float4 tile[3 * kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < m;
  float px = 0.f, py = 0.f, pz = 0.f, lx = 0.f, ly = 0.f, lz = 0.f;
  if (live) {
    px = pts[3 * (size_t)i];
    py = pts[3 * (size_t)i + 1];
    pz = pts[3 * (size_t)i + 2];
    lx = light[3 * (size_t)i];
    ly = light[3 * (size_t)i + 1];
    lz = light[3 * (size_t)i + 2];
  }
  const Box box = {b_0[0], b_0[1], b_0[2], b_1[0], b_1[1], b_1[2]};
  bool blocked = walk<true>(tile, false, live, boxes, inv_rot, inv_trans, nullptr, nullptr, px,
                            py, pz, lx, ly, lz, box);
  blocked = walk<false>(tile, blocked, live, tris, v0, e1, e2, ng, px, py, pz, lx, ly, lz, box);
  if (live) out[i] = blocked ? 1 : 0;
}

}  // namespace

extern "C" {

// pts, light: [m, 3] f32; inv_rot [n_box, 3, 3], inv_trans [n_box, 3] f32;
// box_ids [n_box] int64 or null (all columns), box_valid [n_box] bytes or
// null; v0, e1, e2, ng [T, 3] f32 (null when n_tri is 0); tri_ids, tri_valid
// as for boxes over [n_tri]; b_0, b_1 [3] f32; out [m] bytes.  All
// contiguous; ids must lie inside their tables.  With ids, n_box and n_tri
// count the candidates.  Returns cudaGetLastError() after the launch.
int nt_shadow_query(const void* pts, const void* light, int m, const void* inv_rot,
                    const void* inv_trans, const void* box_ids, const void* box_valid, int n_box,
                    const void* v0, const void* e1, const void* e2, const void* ng,
                    const void* tri_ids, const void* tri_valid, int n_tri, const void* b_0,
                    const void* b_1, void* out, void* stream) {
  if (m < 1 || n_box < 0 || n_tri < 0 || !pts || !light || !b_0 || !b_1 || !out ||
      (n_box > 0 && (!inv_rot || !inv_trans)) || (n_tri > 0 && (!v0 || !e1 || !e2 || !ng))) {
    return (int)cudaErrorInvalidValue;
  }
  const Columns boxes = {(const int64_t*)box_ids, (const bool*)box_valid, n_box};
  const Columns tris = {(const int64_t*)tri_ids, (const bool*)tri_valid, n_tri};
  const int grid = (m + kThreads - 1) / kThreads;
  shadow_query_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)light, m, (const float*)inv_rot, (const float*)inv_trans,
      boxes, (const float*)v0, (const float*)e1, (const float*)e2, (const float*)ng, tris,
      (const float*)b_0, (const float*)b_1, (unsigned char*)out);
  return (int)cudaGetLastError();
}

const char* nt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
