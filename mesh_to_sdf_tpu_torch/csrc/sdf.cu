// Fused point->mesh distance kernels for Hopper (sm_90a): raycast sign and
// normal sign, and the packing of per-triangle records.
//
// Replaces the TPU kernels `_kernel_raycast`
// (mesh_to_sdf_tpu/ops/kernels/pallas_sdf.py:202), called through
// `sdf_raycast_pallas` (:307) and `_raycast_raw` (:390), and
// `_kernel_normal` (pallas_sdf.py:241), called through `sdf_normal_pallas`
// (:425) and `sdf_normal_champions_pallas` (:479). The Python wrappers, the
// plain PyTorch versions and the post-processing (square root, parity vote,
// champion tie-break) live in mesh_to_sdf_tpu_torch/ops/kernels/sdf.py.
//
// What it computes, per query q over all T triangles (a, b, c):
// - raycast: min over triangles of the squared distance, and for AXES of
//   the +X, +Y, +Z rays from q the number of triangles crossed at t > 0;
// - normal: min squared distance over triangles with ap.(ab x ac) > 0, and
//   over the others.
// The pair math is the TPU kernel's division-free ladder
// (pallas_sdf.py:57-140: per-triangle reciprocals, the expanded
// |ap - v ab - w ac|^2) and its strict crossing test with t > 0 written as
// num * den < 0 (pallas_sdf.py:143-178), operation for operation.
//
// What bounds it on the H100: every (query, triangle) pair costs ~53 FP32
// operations for the distance ladder and 13 more per ray axis (10 more
// where the ray passes inside the triangle, a few pairs per query), and
// reads nothing from device memory that is not shared by a whole CTA; 1M
// queries x 20,480 triangles x 3 axes is 2.05e10 pairs, ~1.9e12 operations.
// It is
// bound by FP32 issue (33.5e12 separately rounded operations/s at 700 W,
// since -fmad=false fuses no multiply-add; the ladder's comparisons and
// selects take issue slots too), not by bytes.
//
// What the raycast design does about it:
// - m2s_tri_records packs each triangle's constants once per call into an
//   80-byte record (csrc/tri_record.cuh), so staging is a copy: cp.async
//   into a ring of kRayStages tiles, one barrier per tile, the next tiles in
//   flight while the current one is used.
// - Each thread carries kR queries (kRayR), so a record read from shared
//   memory (five 128-bit broadcast loads) serves kR pairs.
// - The crossing test's edge ac - ab comes from the record, and its rarely
//   needed tail runs only when a lane of the warp is inside (__any_sync).
// - The TPU kernel carried its running min and counts across triangle
//   blocks on an ordered grid axis; here a CTA owns kThreads * kRayR queries
//   and loops over a chunk of the triangles. When the query tiles cannot
//   fill the card (CULLED's few-thousand-query fix-up), the wrapper splits
//   the triangles over gridDim.y chunks, and each CTA combines its result
//   by atomicMin on the int bits of its non-negative d^2 and atomicAdd on
//   the counts: exact and order-free, so every chunk count gives the same
//   bits.
// The normal kernel keeps its first design: one thread per query, triangles
// staged 128 at a time with their constants computed while staging.
//
// Built with -fmad=false so every operation rounds as the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

#include "tri_record.cuh"

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kTile = 128;     // triangles staged per tile (one per thread)

// The normal kernel's staging takes the flags and helpers of
// tri_record.cuh. Its rcp0 writes the division as 1.0f / x, which rounds
// as tri::rcp0's __fdiv_rn (nvcc's default -prec-div=true) and keeps the
// normal kernel's generated code as it is.
using tri::clip01;
using tri::kAllEq;
using tri::kEqAb;
using tri::kF32Max;
using tri::kSegAb;

__device__ __forceinline__ float rcp0(float x) {
  return x == 0.0f ? 0.0f : 1.0f / x;
}

// Per-triangle constants, one shared-memory row of kTile per field.
enum Field {
  kAx, kAy, kAz, kAbx, kAby, kAbz, kAcx, kAcy, kAcz,
  kA, kB, kC, kInvA, kInvC, kInvBc, kInvDen, kNx, kNy, kNz,
  kFields
};

struct Tile {
  float f[kFields][kTile];
  int flags[kTile];
};

// Stage triangles [start, start + kTile) of the soup: thread t computes the
// constants of triangle start + t (if it exists).
__device__ __forceinline__ void stage(Tile& s, const float* __restrict__ ta,
                                      const float* __restrict__ tb,
                                      const float* __restrict__ tc, int start,
                                      int T) {
  const int m = threadIdx.x;
  if (m >= kTile || start + m >= T) return;
  const size_t i = 3 * static_cast<size_t>(start + m);  // 64-bit, as qi
  const float ax = ta[i], ay = ta[i + 1], az = ta[i + 2];
  const float abx = tb[i] - ax, aby = tb[i + 1] - ay, abz = tb[i + 2] - az;
  const float acx = tc[i] - ax, acy = tc[i + 1] - ay, acz = tc[i + 2] - az;
  const float A = abx * abx + aby * aby + abz * abz;
  const float B = abx * acx + aby * acy + abz * acz;
  const float C = acx * acx + acy * acy + acz * acz;
  s.f[kAx][m] = ax;
  s.f[kAy][m] = ay;
  s.f[kAz][m] = az;
  s.f[kAbx][m] = abx;
  s.f[kAby][m] = aby;
  s.f[kAbz][m] = abz;
  s.f[kAcx][m] = acx;
  s.f[kAcy][m] = acy;
  s.f[kAcz][m] = acz;
  s.f[kA][m] = A;
  s.f[kB][m] = B;
  s.f[kC][m] = C;
  s.f[kInvA][m] = rcp0(A);
  s.f[kInvC][m] = rcp0(C);
  s.f[kInvBc][m] = rcp0(A - 2.0f * B + C);
  s.f[kInvDen][m] = rcp0(A * C - B * B);
  s.f[kNx][m] = aby * acz - abz * acy;
  s.f[kNy][m] = abz * acx - abx * acz;
  s.f[kNz][m] = abx * acy - aby * acx;
  const bool eq_ab = abx == 0.0f && aby == 0.0f && abz == 0.0f;
  const bool eq_ac = acx == 0.0f && acy == 0.0f && acz == 0.0f;
  const bool eq_bc = abx == acx && aby == acy && abz == acz;
  s.flags[m] = ((eq_bc || eq_ac) ? kSegAb : 0) | (eq_ab ? kEqAb : 0) |
               ((eq_ab && eq_bc) ? kAllEq : 0);
}

// Squared distance from the query (ap = q - a) to staged triangle m:
// closest_point_vw + dist2 of pallas_sdf.py, same override order.
__device__ __forceinline__ float pair_dist2(const Tile& s, int m, float apx,
                                            float apy, float apz) {
  const float abx = s.f[kAbx][m], aby = s.f[kAby][m], abz = s.f[kAbz][m];
  const float acx = s.f[kAcx][m], acy = s.f[kAcy][m], acz = s.f[kAcz][m];
  const float A = s.f[kA][m], B = s.f[kB][m], C = s.f[kC][m];
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float d3 = d1 - A;
  const float d4 = d2 - B;
  const float d5 = d1 - B;
  const float d6 = d2 - C;
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;
  const float t_ab = d1 * s.f[kInvA][m];
  const float t_ac = d2 * s.f[kInvC][m];
  const float t_bc = (d4 - d3) * s.f[kInvBc][m];
  const float inv_den = s.f[kInvDen][m];

  float v = vb * inv_den;
  float w = vc * inv_den;
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {
    v = 1.0f - t_bc;
    w = t_bc;
  }
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    v = 0.0f;
    w = t_ac;
  }
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    v = t_ab;
    w = 0.0f;
  }
  if (d6 >= 0.0f && d5 <= d6) {
    v = 0.0f;
    w = 1.0f;
  }
  if (d3 >= 0.0f && d4 <= d3) {
    v = 1.0f;
    w = 0.0f;
  }
  if (d1 <= 0.0f && d2 <= 0.0f) {
    v = 0.0f;
    w = 0.0f;
  }
  const int flags = s.flags[m];
  if (flags & kSegAb) {
    v = clip01(t_ab);
    w = 0.0f;
  }
  if (flags & kEqAb) {
    v = 0.0f;
    w = clip01(t_ac);
  }
  if (flags & kAllEq) {
    v = 0.0f;
    w = 0.0f;
  }
  const float ap2 = apx * apx + apy * apy + apz * apz;
  const float dd = ap2 + v * (v * A - 2.0f * d1 + 2.0f * w * B) +
                   w * (w * C - 2.0f * d2);
  return dd < 0.0f ? 0.0f : dd;  // jnp.maximum(dd, 0)
}

// Raycast kernel: queries per thread (the template parameter kR it is
// launched with; 2 from the ptxas report: 90 registers with three axes, no
// spills, under the 128 that kRayMinCtas CTAs per SM leave a thread),
// triangles per staged tile, ring depth, and the CTAs per SM its launch
// bounds ask for (sdf.py's RAYCAST_* mirror these and are checked against
// m2s_sdf_raycast_shape at the first launch).
constexpr int kRayR = 2;
constexpr int kRayTile = 128;
constexpr int kRayStages = 3;
constexpr int kRayMinCtas = 4;

// Strict +axis crossing of a record (pallas_sdf.py:143-178). ap is indexed
// by world axis; the rotation x <- axis, y <- axis + 1, z <- axis + 2
// (mod 3) is resolved at compile time. Every lane of the warp must call it.
template <int kAxis>
__device__ __forceinline__ bool crosses(const tri::Record& t,
                                        const float (&ap)[3]) {
  constexpr int ix = kAxis, iy = (kAxis + 1) % 3, iz = (kAxis + 2) % 3;
  const float ab[3] = {t.r1.x, t.r1.y, t.r1.z};
  const float ac[3] = {t.r2.x, t.r2.y, t.r2.z};
  const float e12[3] = {t.r4.x, t.r4.y, t.r4.z};  // ac - ab
  const float apx = ap[ix], apy = ap[iy], apz = ap[iz];
  const float aby = ab[iy], abz = ab[iz];
  const float acy = ac[iy], acz = ac[iz];
  const float p1y = apy - aby;
  const float p1z = apz - abz;
  const float p2y = apy - acy;
  const float p2z = apz - acz;
  const float w0 = p1z * e12[iy] - p1y * e12[iz];
  const float w1 = p2z * (-acy) - p2y * (-acz);
  const float w2 = apz * aby - apy * abz;
  const bool inside = (w0 < 0.0f && w1 < 0.0f && w2 < 0.0f) ||
                      (w0 > 0.0f && w1 > 0.0f && w2 > 0.0f);
  // A ray passes inside ~2 of all triangles: skip the tail unless a lane
  // of the warp needs it.
  if (!__any_sync(0xffffffffu, inside)) return false;
  const float p1x = apx - ab[ix];
  const float p2x = apx - ac[ix];
  const float num = w0 * apx + w1 * p1x + w2 * p2x;
  const float den = w0 + w1 + w2;
  return inside && num * den < 0.0f;
}

// Triangle i's record from a, b, c (or a, ab, ac with `edges`), each read
// at element i * si + k * sk for component k.
__global__ void __launch_bounds__(kThreads)
tri_records(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, long long T, long long si,
            long long sk, int edges, tri::Record* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= T) return;
  const long long o = i * si;
  const float ax = a[o], ay = a[o + sk], az = a[o + 2 * sk];
  float abx = b[o], aby = b[o + sk], abz = b[o + 2 * sk];
  float acx = c[o], acy = c[o + sk], acz = c[o + 2 * sk];
  if (!edges) {
    abx -= ax;
    aby -= ay;
    abz -= az;
    acx -= ax;
    acy -= ay;
    acz -= az;
  }
  out[i] = tri::pack(ax, ay, az, abx, aby, abz, acx, acy, acz);
}

// One CTA: kThreads * kR queries (thread t holds t, t + kThreads, ...)
// against triangles [blockIdx.y * chunk, + chunk) of the records.
template <int kAxes, int kR>
__global__ void __launch_bounds__(kThreads, kRayMinCtas)
sdf_raycast(const float* __restrict__ queries, int Q,
            const float4* __restrict__ rec, int T, int chunk,
            float* __restrict__ d2_out, int* __restrict__ counts) {
  __shared__ __align__(16) float4 ring[kRayStages][kRayTile * tri::kRecF4];
  constexpr int kC = kAxes > 0 ? kAxes : 1;
  // 64-bit: 3 * qi passes 2^31 from Q = 715,827,883 queries.
  const size_t q0 =
      static_cast<size_t>(blockIdx.x) * (kThreads * kR) + threadIdx.x;
  float px[kR], py[kR], pz[kR], run_min[kR];
  int cnt[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t qi = q0 + static_cast<size_t>(r) * kThreads;
    const bool valid = qi < static_cast<size_t>(Q);
    // Lanes past Q run on a dummy query: every lane reaches __any_sync.
    px[r] = valid ? queries[3 * qi] : 0.0f;
    py[r] = valid ? queries[3 * qi + 1] : 0.0f;
    pz[r] = valid ? queries[3 * qi + 2] : 0.0f;
    run_min[r] = tri::kF32Max;
#pragma unroll
    for (int k = 0; k < kC; ++k) cnt[r][k] = 0;
  }
  const long long t0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long t1 = t0 + chunk < T ? t0 + chunk : T;
  const int n_tiles =
      t1 > t0 ? static_cast<int>((t1 - t0 + kRayTile - 1) / kRayTile) : 0;

  // Tile k of the chunk into ring slot k % kRayStages; always one commit,
  // so the wait below counts groups the same way on every iteration.
  auto fetch = [&](int k) {
    if (k < n_tiles) {
      const long long start = t0 + static_cast<long long>(k) * kRayTile;
      const int n = static_cast<int>(t1 - start < kRayTile ? t1 - start
                                                           : kRayTile);
      const float4* src = rec + start * tri::kRecF4;
      float4* dst = ring[k % kRayStages];
      for (int e = threadIdx.x; e < n * tri::kRecF4; e += kThreads)
        tri::cp_async16(dst + e, src + e);
    }
    tri::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRayStages - 1; ++s) fetch(s);
  for (int k = 0; k < n_tiles; ++k) {
    tri::cp_async_wait<kRayStages - 2>();
    __syncthreads();  // tile k has arrived; all are done with tile k - 1
    fetch(k + kRayStages - 1);
    const float4* s = ring[k % kRayStages];
    const long long left = t1 - (t0 + static_cast<long long>(k) * kRayTile);
    const int n = left < kRayTile ? static_cast<int>(left) : kRayTile;
    for (int m = 0; m < n; ++m) {
      const tri::Record t = tri::load(s, m);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float ap[3] = {px[r] - t.r0.x, py[r] - t.r0.y, pz[r] - t.r0.z};
        const float dd = tri::dist2(t, ap[0], ap[1], ap[2]);
        run_min[r] = dd < run_min[r] ? dd : run_min[r];
        if constexpr (kAxes > 0) cnt[r][0] += crosses<0>(t, ap);
        if constexpr (kAxes > 1) cnt[r][1] += crosses<1>(t, ap);
        if constexpr (kAxes > 2) cnt[r][2] += crosses<2>(t, ap);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t qi = q0 + static_cast<size_t>(r) * kThreads;
    if (qi >= static_cast<size_t>(Q)) continue;
    if (gridDim.y == 1) {
      d2_out[qi] = run_min[r];
#pragma unroll
      for (int k = 0; k < kAxes; ++k)
        counts[static_cast<size_t>(k) * Q + qi] = cnt[r][k];
    } else {
      // d^2 >= 0 (never -0): its int bits order as the floats do.
      atomicMin(reinterpret_cast<int*>(d2_out) + qi,
                __float_as_int(run_min[r]));
#pragma unroll
      for (int k = 0; k < kAxes; ++k)
        if (cnt[r][k]) atomicAdd(counts + static_cast<size_t>(k) * Q + qi,
                                 cnt[r][k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sdf_normal(const float* __restrict__ queries, int Q,
           const float* __restrict__ ta, const float* __restrict__ tb,
           const float* __restrict__ tc, int T, float* __restrict__ pos_out,
           float* __restrict__ neg_out) {
  __shared__ Tile s;
  // 64-bit: 3 * qi passes 2^31 from Q = 715,827,883 queries.
  const size_t qi = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = qi < static_cast<size_t>(Q);
  const size_t q3 = 3 * qi;
  const float px = valid ? queries[q3] : 0.0f;
  const float py = valid ? queries[q3 + 1] : 0.0f;
  const float pz = valid ? queries[q3 + 2] : 0.0f;
  float run_pos = kF32Max;
  float run_neg = kF32Max;

  for (int start = 0; start < T; start += kTile) {
    __syncthreads();
    stage(s, ta, tb, tc, start, T);
    __syncthreads();
    if (!valid) continue;
    const int n = T - start < kTile ? T - start : kTile;
    for (int m = 0; m < n; ++m) {
      const float apx = px - s.f[kAx][m];
      const float apy = py - s.f[kAy][m];
      const float apz = pz - s.f[kAz][m];
      const float dd = pair_dist2(s, m, apx, apy, apz);
      // Normal side (`geo.rs:51-55`): strictly positive dot => positive.
      const float dotn =
          apx * s.f[kNx][m] + apy * s.f[kNy][m] + apz * s.f[kNz][m];
      if (dotn > 0.0f) {
        run_pos = dd < run_pos ? dd : run_pos;
      } else {
        run_neg = dd < run_neg ? dd : run_neg;
      }
    }
  }
  if (!valid) return;
  pos_out[qi] = run_pos;
  neg_out[qi] = run_neg;
}

}  // namespace

// Packed records (out: (T, 20) f32, 16-byte aligned; see
// csrc/tri_record.cuh) of T triangles: component k of triangle i of a, b, c
// at element i * si + k * sk; with `edges` b and c hold ab and ac, else the
// vertices. Launches one kernel on `stream`, allocates nothing, returns the
// launch error (cudaSuccess = 0).
extern "C" int m2s_tri_records(const float* a, const float* b,
                               const float* c, long long T, long long si,
                               long long sk, int edges, float* out,
                               void* stream) {
  if (T <= 0) return cudaSuccess;
  const long long ctas = (T + kThreads - 1) / kThreads;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  tri_records<<<static_cast<unsigned>(ctas), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      a, b, c, T, si, sk, edges, reinterpret_cast<tri::Record*>(out));
  return cudaGetLastError();
}

// The raycast kernel's launch shape, which sdf.py's split rule assumes:
// out[0] queries per CTA, out[1] triangles per staged tile, out[2] CTAs per
// SM its launch bounds ask for. Returns cudaSuccess.
extern "C" int m2s_sdf_raycast_shape(int* out) {
  out[0] = kThreads * kRayR;
  out[1] = kRayTile;
  out[2] = kRayMinCtas;
  return cudaSuccess;
}

// Min squared distance (d2: (Q,) f32) and +axis crossing counts (counts:
// (axes, Q) int32, axes in 0..3) of every query (queries: (Q, 3) f32) over
// T triangles given as packed records (rec: (T, 20) f32 from
// m2s_tri_records). The triangles are split into ceil(T / chunk) chunks
// over gridDim.y (at most 65,535); with more than one, d2 must hold F32_MAX
// and counts 0 on entry. Launches one kernel on `stream`, allocates
// nothing, returns the launch error (cudaSuccess = 0).
extern "C" int m2s_sdf_raycast(const float* queries, int Q, const float* rec,
                               int T, int chunk, int axes, float* d2,
                               int* counts, void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (chunk <= 0) return cudaErrorInvalidValue;
  const long long chunks = T > 0 ? (static_cast<long long>(T) + chunk - 1) /
                                       chunk
                                 : 1;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const long long ctas =
      (static_cast<long long>(Q) + kThreads * kRayR - 1) / (kThreads * kRayR);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  switch (axes) {
    case 0:
      sdf_raycast<0, kRayR><<<grid, kThreads, 0, st>>>(
          queries, Q, r4, T, chunk, d2, counts);
      break;
    case 1:
      sdf_raycast<1, kRayR><<<grid, kThreads, 0, st>>>(
          queries, Q, r4, T, chunk, d2, counts);
      break;
    case 2:
      sdf_raycast<2, kRayR><<<grid, kThreads, 0, st>>>(
          queries, Q, r4, T, chunk, d2, counts);
      break;
    case 3:
      sdf_raycast<3, kRayR><<<grid, kThreads, 0, st>>>(
          queries, Q, r4, T, chunk, d2, counts);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Min squared distance over the triangles on the positive normal side
// (pos2) and over the others (neg2), (Q,) f32 each, F32_MAX where a side
// has none. Same inputs and contract as m2s_sdf_raycast.
extern "C" int m2s_sdf_normal(const float* queries, int Q, const float* ta,
                              const float* tb, const float* tc, int T,
                              float* pos2, float* neg2, void* stream) {
  if (Q <= 0) return cudaSuccess;
  const dim3 grid((Q + kThreads - 1) / kThreads);
  sdf_normal<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, Q, ta, tb, tc, T, pos2, neg2);
  return cudaGetLastError();
}
