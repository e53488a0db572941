// Directional closest-point-transform sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel`
// (mesh_to_sdf_tpu/ops/kernels/pallas_sweep.py:142), called through
// `sweep_oriented` (pallas_sweep.py:269). The Python wrapper and the plain
// PyTorch version live in mesh_to_sdf_tpu_torch/ops/kernels/sweep.py.
//
// What it computes: volumes are laid out sweep-axis first, state
// (n0, n1, n2) and vertex planes (n0, 9, n1, n2). Each cell of slice s keeps
// its two best distinct triangles (distance, 9 vertex coordinates, id). It
// merges 18 candidates: both slots of the 3x3 window of the previous slice
// along the sweep, each re-evaluated exactly at the cell centre with the
// division-free closest-point ladder (`_pt_dist2`, pallas_sweep.py:42).
// Candidates are merged in the TPU kernel's order (dy, then dz, then slot 1
// before slot 2) with the same strict `<` tests, so ties resolve the same
// way. Edge cells and the first slice get sentinel candidates (vertices at
// PAD_COORD, id -1), as the TPU kernel's margins and column masks give.
//
// What bounds it on the H100: the sweep is a recurrence along n0, so each
// slice depends on the previous one; per slice the work is one plane
// (n1*n2 <= 64K cells at 256^3), 18 candidates x ~90 flops per cell, and
// ~88 B of state read + written per cell. A 256^2 plane is ~12 M candidate
// evaluations, a few microseconds of the card's FP32 rate, so at this size
// the launch latency of the slice loop dominates, not flops or bytes.
//
// What the design does about it: the TPU ran the sweep axis as a sequential
// Pallas grid with the carry in VMEM. Hopper has no sequential grid, so the
// launch order is the sequential step: the C entry point loops over the n0
// slices and launches one kernel per slice on the caller's stream, one
// thread per plane cell, updating the volumes in place. Slice s reads its own
// state and the already-updated slice s-1 (s+1 when reversed). The previous
// slice (~88 B per cell, 5.8 MB at 256^2) stays resident in the 50 MB L2, so
// the 3x3 window reads cost L2 traffic, not HBM. `reverse` only changes the
// slice order: no flipped copies. Batching slices into a persistent kernel or
// a CUDA graph is left to a later change.
//
// Built with -fmad=false so the ladder rounds exactly as the plain version.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kPadCoord = 1.0e18f;
constexpr int kThreads = 256;

__device__ __forceinline__ float rcp0(float x) {
  return x == 0.0f ? 0.0f : 1.0f / x;
}

// jnp.clip(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Exact squared point-triangle distance, operation for operation
// pallas_sweep.py:42-112 (same association order, no contraction).
__device__ __forceinline__ float pt_dist2(float px, float py, float pz,
                                          const float* v) {
  const float ax = v[0], ay = v[1], az = v[2];
  const float bx = v[3], by = v[4], bz = v[5];
  const float cx = v[6], cy = v[7], cz = v[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = px - ax, apy = py - ay, apz = pz - az;

  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float A = abx * abx + aby * aby + abz * abz;
  const float B = abx * acx + aby * acy + abz * acz;
  const float C = acx * acx + acy * acy + acz * acz;
  const float d3 = d1 - A;
  const float d4 = d2 - B;
  const float d5 = d1 - B;
  const float d6 = d2 - C;
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;

  const float t_ab = d1 * rcp0(A);
  const float t_ac = d2 * rcp0(C);
  const float t_bc = (d4 - d3) * rcp0(A - 2.0f * B + C);
  const float inv_den = rcp0(A * C - B * B);

  float v_ = vb * inv_den;
  float w_ = vc * inv_den;
  if ((va <= 0.0f) & (d4 - d3 >= 0.0f) & (d5 - d6 >= 0.0f)) {
    v_ = 1.0f - t_bc;
    w_ = t_bc;
  }
  if ((vb <= 0.0f) & (d2 >= 0.0f) & (d6 <= 0.0f)) {
    v_ = 0.0f;
    w_ = t_ac;
  }
  if ((vc <= 0.0f) & (d1 >= 0.0f) & (d3 <= 0.0f)) {
    v_ = t_ab;
    w_ = 0.0f;
  }
  if ((d6 >= 0.0f) & (d5 <= d6)) {
    v_ = 0.0f;
    w_ = 1.0f;
  }
  if ((d3 >= 0.0f) & (d4 <= d3)) {
    v_ = 1.0f;
    w_ = 0.0f;
  }
  if ((d1 <= 0.0f) & (d2 <= 0.0f)) {
    v_ = 0.0f;
    w_ = 0.0f;
  }

  const bool eq_ab = (abx == 0.0f) & (aby == 0.0f) & (abz == 0.0f);
  const bool eq_ac = (acx == 0.0f) & (acy == 0.0f) & (acz == 0.0f);
  const bool eq_bc = (abx == acx) & (aby == acy) & (abz == acz);
  if (eq_bc | eq_ac) {
    v_ = clip01(t_ab);
    w_ = 0.0f;
  }
  if (eq_ab) {
    v_ = 0.0f;
    w_ = clip01(t_ac);
  }
  if (eq_ab & eq_bc) {
    v_ = 0.0f;
    w_ = 0.0f;
  }

  const float ap2 = apx * apx + apy * apy + apz * apz;
  const float dd = ap2 + v_ * (v_ * A - 2.0f * d1 + 2.0f * w_ * B) +
                   w_ * (w_ * C - 2.0f * d2);
  return dd < 0.0f ? 0.0f : dd;  // jnp.maximum(dd, 0): NaN stays NaN
}

// One slice of one directional sweep. `prev` < 0: first slice, every
// candidate is the sentinel.
__global__ void __launch_bounds__(kThreads)
sweep_slice(float* __restrict__ d1, float* __restrict__ v1,
            int* __restrict__ i1, float* __restrict__ d2,
            float* __restrict__ v2, int* __restrict__ i2, int n1, int n2,
            int s, int prev, float fa, float ca, float fr, float cr,
            float fcol, float ccol, int comp0, int comp1) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = static_cast<size_t>(n1) * n2;
  if (cell >= static_cast<int>(plane)) return;
  const int r = cell / n2;
  const int c = cell - r * n2;

  // Cell centre: world component comp0 varies along the sweep, comp1 along
  // plane rows, the remaining one along plane columns.
  const float coord_a = fa + static_cast<float>(s) * ca;
  const float coord_r = fr + static_cast<float>(r) * cr;
  const float coord_c = fcol + static_cast<float>(c) * ccol;
  const float px = comp0 == 0 ? coord_a : (comp1 == 0 ? coord_r : coord_c);
  const float py = comp0 == 1 ? coord_a : (comp1 == 1 ? coord_r : coord_c);
  const float pz = comp0 == 2 ? coord_a : (comp1 == 2 ? coord_r : coord_c);

  const size_t o = static_cast<size_t>(s) * plane + cell;
  const size_t ov = static_cast<size_t>(s) * 9 * plane + cell;
  float bd1 = d1[o], bd2 = d2[o];
  int bi1 = i1[o], bi2 = i2[o];
  float bv1[9], bv2[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    bv1[k] = v1[ov + k * plane];
    bv2[k] = v2[ov + k * plane];
  }

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int rr = r - 1 + dy;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int cc = c - 1 + dz;
      const bool inside = prev >= 0 && rr >= 0 && rr < n1 && cc >= 0 && cc < n2;
      const size_t q = static_cast<size_t>(rr) * n2 + cc;
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const float* vsrc = slot == 0 ? v1 : v2;
        const int* isrc = slot == 0 ? i1 : i2;
        float cv[9];
        int ci = -1;
        if (inside) {
          const size_t pv = static_cast<size_t>(prev) * 9 * plane + q;
#pragma unroll
          for (int k = 0; k < 9; ++k) cv[k] = vsrc[pv + k * plane];
          ci = isrc[static_cast<size_t>(prev) * plane + q];
        } else {
#pragma unroll
          for (int k = 0; k < 9; ++k) cv[k] = kPadCoord;
        }
        const float dc = sqrtf(pt_dist2(px, py, pz, cv));

        // _merge2 (pallas_sweep.py:115): slot 2 first, it reads the old
        // slot 1.
        const bool same1 = ci == bi1;
        const bool b1 = dc < bd1;
        if (b1 && !same1) {
          bd2 = bd1;
          bi2 = bi1;
#pragma unroll
          for (int k = 0; k < 9; ++k) bv2[k] = bv1[k];
        } else if (!b1 && !same1 && dc < bd2) {
          bd2 = dc;
          bi2 = ci;
#pragma unroll
          for (int k = 0; k < 9; ++k) bv2[k] = cv[k];
        }
        if (b1) {
          bd1 = dc;
          bi1 = ci;
#pragma unroll
          for (int k = 0; k < 9; ++k) bv1[k] = cv[k];
        }
      }
    }
  }

  d1[o] = bd1;
  i1[o] = bi1;
  d2[o] = bd2;
  i2[o] = bi2;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    v1[ov + k * plane] = bv1[k];
    v2[ov + k * plane] = bv2[k];
  }
}

}  // namespace

// One directional sweep over volumes laid out sweep-axis first, updated in
// place. first/size: world (x, y, z) grid parameters; comp0/comp1/comp2: the
// world component that varies along the sweep axis / plane rows / plane
// columns. Launches n0 kernels on `stream`, allocates nothing, and returns
// the first launch error (cudaSuccess = 0).
extern "C" int m2s_sweep_oriented(float* d1, float* v1, int* i1, float* d2,
                                  float* v2, int* i2, int n0, int n1, int n2,
                                  int reverse, float f0, float f1, float f2,
                                  float c0, float c1, float c2, int comp0,
                                  int comp1, int comp2, void* stream) {
  const float first[3] = {f0, f1, f2};
  const float size[3] = {c0, c1, c2};
  const long long plane = static_cast<long long>(n1) * n2;
  if (n0 <= 0 || plane <= 0) return cudaSuccess;
  const int blocks = static_cast<int>((plane + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < n0; ++k) {
    const int s = reverse ? n0 - 1 - k : k;
    const int prev = k == 0 ? -1 : (reverse ? s + 1 : s - 1);
    sweep_slice<<<blocks, kThreads, 0, st>>>(
        d1, v1, i1, d2, v2, i2, n1, n2, s, prev, first[comp0], size[comp0],
        first[comp1], size[comp1], first[comp2], size[comp2], comp0, comp1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
