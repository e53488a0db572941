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
// operations for the distance ladder, 13 more per ray axis (10 more where
// the ray passes inside the triangle, a few pairs per query) or 5 for the
// normal side, and reads nothing from device memory that is not shared by a
// whole CTA; 1M queries x 20,480 triangles x 3 axes is 2.05e10 pairs, ~1.9e12
// operations. It is bound by FP32 issue (33.5e12 separately rounded
// operations/s at 700 W, since -fmad=false fuses no multiply-add; the
// ladder's comparisons and selects take issue slots too), not by bytes.
//
// What the design does about it (one kernel template for both signs):
// - m2s_tri_records packs each triangle's constants once per call into an
//   80-byte record (csrc/tri_record.cuh; a normal record carries ab x ac
//   where a raycast record carries ac - ab), so staging is a copy: cp.async
//   into a ring of kRayStages tiles, one barrier per tile, the next tiles in
//   flight while the current one is used.
// - Each thread carries kR queries (kRayR, kNormalR), so a record read from
//   shared memory (five 128-bit broadcast loads) serves kR pairs.
// - The crossing test's rarely needed tail runs only when a lane of the warp
//   is inside (__any_sync); the normal side picks its running min by a
//   select, not a branch.
// - The TPU kernel carried its running minima and counts across triangle
//   blocks on an ordered grid axis; here a CTA owns kThreads * kR queries
//   and loops over a chunk of the triangles. When the query tiles cannot
//   fill the card (CULLED's few-thousand-query fix-up and fallback), the
//   wrapper splits the triangles over gridDim.y chunks, and each CTA
//   combines its result by atomicMin on the int bits of its non-negative d^2
//   and atomicAdd on the counts: exact and order-free, so every chunk count
//   gives the same bits.
//
// Built with -fmad=false so every operation rounds as the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

#include "tri_record.cuh"

namespace {

constexpr int kThreads = 128;  // threads per CTA

// Queries per thread of the raycast kernel (2: 90 registers with three
// axes, no spills, under the 128 that kRayMinCtas CTAs per SM leave a
// thread) and of the normal kernel (4, from its ptxas report), triangles
// per staged tile, ring depth, and the CTAs per SM the launch bounds ask
// for (sdf.py's RAYCAST_* and NORMAL_CTA_QUERIES mirror these and are
// checked against m2s_sdf_raycast_shape at the first launch).
constexpr int kRayR = 2;
constexpr int kNormalR = 4;
constexpr int kRayTile = 128;
constexpr int kRayStages = 3;
constexpr int kRayMinCtas = 4;
// kMode of the normal-sign kernel; 0..3 are the raycast kernel's axes.
constexpr int kNormal = -1;

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
// at element i * si + k * sk for component k; `normal` packs the normal
// kind.
__global__ void __launch_bounds__(kThreads)
tri_records(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, long long T, long long si,
            long long sk, int edges, int normal,
            tri::Record* __restrict__ out) {
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
  out[i] = tri::pack(ax, ay, az, abx, aby, abz, acx, acy, acz, normal != 0);
}

// One CTA: kThreads * kR queries (thread t holds t, t + kThreads, ...)
// against triangles [blockIdx.y * chunk, + chunk) of the records. kMode
// 0..3: raycast with that many axes (out0 = d^2, counts); kNormal: normal
// sign (out0 = pos2, out1 = neg2, records of the normal kind).
template <int kMode, int kR>
__global__ void __launch_bounds__(kThreads, kRayMinCtas)
sdf_pairs(const float* __restrict__ queries, int Q,
          const float4* __restrict__ rec, int T, int chunk,
          float* __restrict__ out0, int* __restrict__ counts,
          float* __restrict__ out1) {
  __shared__ __align__(16) float4 ring[kRayStages][kRayTile * tri::kRecF4];
  constexpr int kAxes = kMode > 0 ? kMode : 0;
  constexpr int kC = kAxes > 0 ? kAxes : 1;
  // 64-bit: 3 * qi passes 2^31 from Q = 715,827,883 queries.
  const size_t q0 =
      static_cast<size_t>(blockIdx.x) * (kThreads * kR) + threadIdx.x;
  float px[kR], py[kR], pz[kR], run_min[kR], run_neg[kR];
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
    run_neg[r] = tri::kF32Max;
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
        if constexpr (kMode == kNormal) {
          // Normal side (`geo.rs:51-55`): a strictly positive dot with
          // n = ab x ac is positive. Both minima by selects, no branch.
          const float dotn = ap[0] * t.r4.x + ap[1] * t.r4.y + ap[2] * t.r4.z;
          const bool pos = dotn > 0.0f;
          run_min[r] = pos && dd < run_min[r] ? dd : run_min[r];
          run_neg[r] = !pos && dd < run_neg[r] ? dd : run_neg[r];
        } else {
          run_min[r] = dd < run_min[r] ? dd : run_min[r];
          if constexpr (kAxes > 0) cnt[r][0] += crosses<0>(t, ap);
          if constexpr (kAxes > 1) cnt[r][1] += crosses<1>(t, ap);
          if constexpr (kAxes > 2) cnt[r][2] += crosses<2>(t, ap);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t qi = q0 + static_cast<size_t>(r) * kThreads;
    if (qi >= static_cast<size_t>(Q)) continue;
    if (gridDim.y == 1) {
      out0[qi] = run_min[r];
      if constexpr (kMode == kNormal) out1[qi] = run_neg[r];
#pragma unroll
      for (int k = 0; k < kAxes; ++k)
        counts[static_cast<size_t>(k) * Q + qi] = cnt[r][k];
    } else {
      // d^2 >= 0 (never -0): its int bits order as the floats do.
      atomicMin(reinterpret_cast<int*>(out0) + qi,
                __float_as_int(run_min[r]));
      if constexpr (kMode == kNormal)
        atomicMin(reinterpret_cast<int*>(out1) + qi,
                  __float_as_int(run_neg[r]));
#pragma unroll
      for (int k = 0; k < kAxes; ++k)
        if (cnt[r][k]) atomicAdd(counts + static_cast<size_t>(k) * Q + qi,
                                 cnt[r][k]);
    }
  }
}

// One launch of sdf_pairs<kMode, kR> with the triangles split into
// ceil(T / chunk) chunks over gridDim.y.
template <int kMode, int kR>
int launch_pairs(const float* queries, int Q, const float* rec, int T,
                 int chunk, float* out0, int* counts, float* out1,
                 void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (chunk <= 0) return cudaErrorInvalidValue;
  const long long chunks = T > 0 ? (static_cast<long long>(T) + chunk - 1) /
                                       chunk
                                 : 1;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const long long ctas =
      (static_cast<long long>(Q) + kThreads * kR - 1) / (kThreads * kR);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  sdf_pairs<kMode, kR><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      queries, Q, reinterpret_cast<const float4*>(rec), T, chunk, out0,
      counts, out1);
  return cudaGetLastError();
}

}  // namespace

// Packed records (out: (T, 20) f32, 16-byte aligned; see
// csrc/tri_record.cuh) of T triangles: component k of triangle i of a, b, c
// at element i * si + k * sk; with `edges` b and c hold ab and ac, else the
// vertices; with `normal` the normal kind. Launches one kernel on `stream`,
// allocates nothing, returns the launch error (cudaSuccess = 0).
extern "C" int m2s_tri_records(const float* a, const float* b,
                               const float* c, long long T, long long si,
                               long long sk, int edges, int normal,
                               float* out, void* stream) {
  if (T <= 0) return cudaSuccess;
  const long long ctas = (T + kThreads - 1) / kThreads;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  tri_records<<<static_cast<unsigned>(ctas), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      a, b, c, T, si, sk, edges, normal,
      reinterpret_cast<tri::Record*>(out));
  return cudaGetLastError();
}

// The launch shape that sdf.py's split rule assumes: out[0] raycast queries
// per CTA, out[1] triangles per staged tile, out[2] CTAs per SM the launch
// bounds ask for, out[3] normal-kernel queries per CTA. Returns cudaSuccess.
extern "C" int m2s_sdf_raycast_shape(int* out) {
  out[0] = kThreads * kRayR;
  out[1] = kRayTile;
  out[2] = kRayMinCtas;
  out[3] = kThreads * kNormalR;
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
  switch (axes) {
    case 0:
      return launch_pairs<0, kRayR>(queries, Q, rec, T, chunk, d2, counts,
                                    nullptr, stream);
    case 1:
      return launch_pairs<1, kRayR>(queries, Q, rec, T, chunk, d2, counts,
                                    nullptr, stream);
    case 2:
      return launch_pairs<2, kRayR>(queries, Q, rec, T, chunk, d2, counts,
                                    nullptr, stream);
    case 3:
      return launch_pairs<3, kRayR>(queries, Q, rec, T, chunk, d2, counts,
                                    nullptr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Min squared distance over the triangles on the positive normal side
// (pos2) and over the others (neg2), (Q,) f32 each, F32_MAX where a side
// has none, from records of the normal kind. Same split and contract as
// m2s_sdf_raycast: with more than one chunk, pos2 and neg2 must hold
// F32_MAX on entry.
extern "C" int m2s_sdf_normal(const float* queries, int Q, const float* rec,
                              int T, int chunk, float* pos2, float* neg2,
                              void* stream) {
  return launch_pairs<kNormal, kNormalR>(queries, Q, rec, T, chunk, pos2,
                                         nullptr, neg2, stream);
}
