// Fused point->mesh distance kernels for Hopper (sm_90a): raycast sign and
// normal sign.
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
// What bounds it on the H100: every (query, triangle) pair costs ~70 FP32
// operations for the distance ladder and ~20 more per ray axis, and reads
// nothing from memory that is not shared by the whole CTA; 1M queries x
// 20,480 triangles is 2.05e10 pairs, ~2-3 TFLOP. It is bound by FP32
// issue (67 TFLOP/s peak at 700 W; the comparisons and selects of the ladder
// do not count as flops but take issue slots), not by bytes.
//
// What the design does about it: the TPU kernel carried its running min and
// counts across triangle blocks on an ordered grid axis; Hopper has none, so
// one thread owns one query and loops over all triangles itself, with no
// atomics and no second pass. Triangles are staged through shared memory
// in tiles of 128; while staging, each thread computes one triangle's
// per-triangle constants (ab, ac, |ab|^2, ab.ac, |ac|^2, the four safe
// reciprocals, the degenerate-triangle flags, the normal) once, so the pair
// loop does only per-pair work, and every thread reads the same triangle
// (a shared-memory broadcast). The loop is bounded by T: no padding
// triangles. Small Q (a few hundred queries) leaves most SMs idle.
//
// Built with -fmad=false so every operation rounds as the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // queries per CTA
constexpr int kTile = 128;     // triangles staged per tile (one per thread)
constexpr float kF32Max = 3.402823466e+38f;

// Per-triangle constants, one shared-memory row of kTile per field.
enum Field {
  kAx, kAy, kAz, kAbx, kAby, kAbz, kAcx, kAcy, kAcz,
  kA, kB, kC, kInvA, kInvC, kInvBc, kInvDen, kNx, kNy, kNz,
  kFields
};
// Degenerate-triangle flags (pallas_sdf.py:121-133).
constexpr int kSegAb = 1;  // b == c or c == a: segment [a, b]
constexpr int kEqAb = 2;   // b == a: segment [a, c]
constexpr int kAllEq = 4;  // a == b == c: vertex a

__device__ __forceinline__ float rcp0(float x) {
  return x == 0.0f ? 0.0f : 1.0f / x;
}

// jnp.clip(x, 0, 1).
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

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

// Strict +axis crossing of staged triangle m (pallas_sdf.py:143-178). ap,
// ab, ac are indexed by world axis; the rotation x <- axis, y <- axis + 1,
// z <- axis + 2 (mod 3) is resolved at compile time.
template <int kAxis>
__device__ __forceinline__ bool crosses(const Tile& s, int m,
                                        const float (&ap)[3]) {
  constexpr int ix = kAxis, iy = (kAxis + 1) % 3, iz = (kAxis + 2) % 3;
  const float apx = ap[ix], apy = ap[iy], apz = ap[iz];
  const float abx = s.f[kAbx + ix][m], aby = s.f[kAbx + iy][m],
              abz = s.f[kAbx + iz][m];
  const float acx = s.f[kAcx + ix][m], acy = s.f[kAcx + iy][m],
              acz = s.f[kAcx + iz][m];
  const float p1y = apy - aby;
  const float p1z = apz - abz;
  const float p2y = apy - acy;
  const float p2z = apz - acz;
  const float e12y = acy - aby;
  const float e12z = acz - abz;
  const float w0 = p1z * e12y - p1y * e12z;
  const float w1 = p2z * (-acy) - p2y * (-acz);
  const float w2 = apz * aby - apy * abz;
  const bool inside = (w0 < 0.0f && w1 < 0.0f && w2 < 0.0f) ||
                      (w0 > 0.0f && w1 > 0.0f && w2 > 0.0f);
  if (!inside) return false;
  const float p1x = apx - abx;
  const float p2x = apx - acx;
  const float num = w0 * apx + w1 * p1x + w2 * p2x;
  const float den = w0 + w1 + w2;
  return num * den < 0.0f;
}

template <int kAxes>
__global__ void __launch_bounds__(kThreads)
sdf_raycast(const float* __restrict__ queries, int Q,
            const float* __restrict__ ta, const float* __restrict__ tb,
            const float* __restrict__ tc, int T, float* __restrict__ d2_out,
            int* __restrict__ counts) {
  __shared__ Tile s;
  // 64-bit: 3 * qi passes 2^31 from Q = 715,827,883 queries.
  const size_t qi = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = qi < static_cast<size_t>(Q);
  const size_t q3 = 3 * qi;
  const float px = valid ? queries[q3] : 0.0f;
  const float py = valid ? queries[q3 + 1] : 0.0f;
  const float pz = valid ? queries[q3 + 2] : 0.0f;
  float run_min = kF32Max;
  int cnt[kAxes > 0 ? kAxes : 1] = {};

  for (int start = 0; start < T; start += kTile) {
    __syncthreads();  // the previous tile has been consumed
    stage(s, ta, tb, tc, start, T);
    __syncthreads();
    if (!valid) continue;
    const int n = T - start < kTile ? T - start : kTile;
    for (int m = 0; m < n; ++m) {
      const float ap[3] = {px - s.f[kAx][m], py - s.f[kAy][m],
                           pz - s.f[kAz][m]};
      const float dd = pair_dist2(s, m, ap[0], ap[1], ap[2]);
      run_min = dd < run_min ? dd : run_min;
      if constexpr (kAxes > 0) cnt[0] += crosses<0>(s, m, ap);
      if constexpr (kAxes > 1) cnt[1] += crosses<1>(s, m, ap);
      if constexpr (kAxes > 2) cnt[2] += crosses<2>(s, m, ap);
    }
  }
  if (!valid) return;
  d2_out[qi] = run_min;
#pragma unroll
  for (int k = 0; k < kAxes; ++k) counts[static_cast<size_t>(k) * Q + qi] = cnt[k];
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

// Min squared distance (d2: (Q,) f32) and +axis crossing counts (counts:
// (axes, Q) int32, axes in 0..3) of every query (queries: (Q, 3) f32) over
// the triangles ta/tb/tc ((T, 3) f32 each). Launches one kernel on
// `stream`, allocates nothing, returns the launch error (cudaSuccess = 0).
extern "C" int m2s_sdf_raycast(const float* queries, int Q, const float* ta,
                               const float* tb, const float* tc, int T,
                               int axes, float* d2, int* counts,
                               void* stream) {
  if (Q <= 0) return cudaSuccess;
  const dim3 grid((Q + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (axes) {
    case 0:
      sdf_raycast<0><<<grid, kThreads, 0, st>>>(queries, Q, ta, tb, tc, T,
                                               d2, counts);
      break;
    case 1:
      sdf_raycast<1><<<grid, kThreads, 0, st>>>(queries, Q, ta, tb, tc, T,
                                               d2, counts);
      break;
    case 2:
      sdf_raycast<2><<<grid, kThreads, 0, st>>>(queries, Q, ta, tb, tc, T,
                                               d2, counts);
      break;
    case 3:
      sdf_raycast<3><<<grid, kThreads, 0, st>>>(queries, Q, ta, tb, tc, T,
                                               d2, counts);
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
