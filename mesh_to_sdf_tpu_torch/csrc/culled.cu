// Block-culled distance and anchor-segment crossings for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_culled`
// (mesh_to_sdf_tpu/ops/kernels/pallas_culled.py:516), called through
// `culled_dist_pallas` (:598) by the union engine, and the body of the
// gather engine (mesh_to_sdf_tpu/ops/culling.py:464-500, plain XLA there,
// the hot loop of the default CULLED route). The Python wrapper, the plain
// PyTorch version and phase A live in
// mesh_to_sdf_tpu_torch/ops/kernels/culled.py.
//
// What it computes: queries come in groups (a 1024-query tile for the union
// engine, an st-query sub-tile of 16, 32 or 64 for the gather engine); row g
// of `tbl` lists the candidate blocks of group g, pad id n_blocks after the
// real ones. For each query: the minimum over the triangles of those blocks
// of the squared distance (the division-free ladder of
// pallas_sdf._closest_point_vw + _dist2, as csrc/sdf.cu's pair_dist2), and,
// given anchors, the number of strict-interior Moller-Trumbore crossings of
// the segment from the query to its anchor (pallas_culled.py:567-591). A
// block row holds 9 planes of tb floats: a, ab, ac.
//
// What bounds it on the H100: each (query, triangle) pair costs ~53 FP32
// operations for the ladder and ~43 more for the crossing test; each block
// (9 KB) is read by every query of a group that lists it. At 1M queries,
// 32 blocks of 256 per query, that is 8.2e9 pairs, ~0.8 TFLOP: bound by
// FP32 throughput (67 TFLOP/s at 700 W, ~12 ms), not by the bytes (the distinct
// inputs are a few hundred MB).
//
// What the design does about it: one thread owns one query and loops over
// its group's slots, so the running min and count stay in registers (the
// TPU kernel carried them on an ordered grid axis). A CTA of 128 threads
// holds 128 / group groups (gather engine) or a 128-query slice of one
// group (union engine); each group has its own slice of shared memory, into
// which its threads stage one triangle each of the current block, with the
// per-triangle constants (|ab|^2, ab.ac, |ac|^2, the four safe reciprocals,
// the degenerate flags) computed once while staging; the pair loop then
// reads the same triangle in every thread (a broadcast). The slot loop stops
// at the first slot that is pad in every group of the CTA, which is the
// TPU kernel's pl.when(slot != n_blocks). The group width is a template
// parameter so the pair loop has a fixed trip count.
//
// Built with -fmad=false so every operation rounds as the plain version's;
// 1/det is an IEEE division (__fdiv_rn), as the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // queries per CTA
constexpr float kF32Max = 3.402823466e+38f;

enum Field {
  kAx, kAy, kAz, kAbx, kAby, kAbz, kAcx, kAcy, kAcz,
  kA, kB, kC, kInvA, kInvC, kInvBc, kInvDen,
  kFields
};
// Degenerate-triangle flags (pallas_sdf.py:121-133).
constexpr int kSegAb = 1;  // b == c or c == a: segment [a, b]
constexpr int kEqAb = 2;   // b == a: segment [a, c]
constexpr int kAllEq = 4;  // a == b == c: vertex a

struct Tile {
  float f[kFields][kThreads];
  int flags[kThreads];
};

__device__ __forceinline__ float rcp0(float x) {
  return x == 0.0f ? 0.0f : __fdiv_rn(1.0f, x);
}

__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Stage triangle i of block row `row` (9 planes of tb floats) into slot m.
__device__ __forceinline__ void stage(Tile& s, int m,
                                      const float* __restrict__ row, int tb,
                                      int i) {
  const float ax = row[i], ay = row[tb + i], az = row[2 * tb + i];
  const float abx = row[3 * tb + i], aby = row[4 * tb + i],
              abz = row[5 * tb + i];
  const float acx = row[6 * tb + i], acy = row[7 * tb + i],
              acz = row[8 * tb + i];
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
  const bool eq_ab = abx == 0.0f && aby == 0.0f && abz == 0.0f;
  const bool eq_ac = acx == 0.0f && acy == 0.0f && acz == 0.0f;
  const bool eq_bc = abx == acx && aby == acy && abz == acz;
  s.flags[m] = ((eq_bc || eq_ac) ? kSegAb : 0) | (eq_ab ? kEqAb : 0) |
               ((eq_ab && eq_bc) ? kAllEq : 0);
}

// Running min of the squared distance from the query (ap = q - a) to
// staged triangle m: closest_point_vw + dist2, same override order.
__device__ __forceinline__ void min_dist2(const Tile& s, int m, float apx,
                                          float apy, float apz,
                                          float& run_min) {
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
  float dd = ap2 + v * (v * A - 2.0f * d1 + 2.0f * w * B) +
             w * (w * C - 2.0f * d2);
  dd = dd < 0.0f ? 0.0f : dd;  // jnp.maximum(dd, 0)
  run_min = dd < run_min ? dd : run_min;
}

// Adds 1 to `cnt` if the segment q -> q + (dxx, dyy, dzz) crosses staged
// triangle m strictly inside (culled.segment_crossings).
__device__ __forceinline__ void add_crossing(const Tile& s, int m, float apx,
                                             float apy, float apz, float dxx,
                                             float dyy, float dzz, int& cnt) {
  const float abx = s.f[kAbx][m], aby = s.f[kAby][m], abz = s.f[kAbz][m];
  const float acx = s.f[kAcx][m], acy = s.f[kAcy][m], acz = s.f[kAcz][m];
  const float pvx = dyy * acz - dzz * acy;
  const float pvy = dzz * acx - dxx * acz;
  const float pvz = dxx * acy - dyy * acx;
  const float det = abx * pvx + aby * pvy + abz * pvz;
  const float inv = rcp0(det);
  const float u = (apx * pvx + apy * pvy + apz * pvz) * inv;
  const float qvx = apy * abz - apz * aby;
  const float qvy = apz * abx - apx * abz;
  const float qvz = apx * aby - apy * abx;
  const float vv = (dxx * qvx + dyy * qvy + dzz * qvz) * inv;
  const float tt = (acx * qvx + acy * qvy + acz * qvz) * inv;
  cnt += (det != 0.0f && u > 0.0f && vv > 0.0f && u + vv < 1.0f &&
          tt > 0.0f && tt < 1.0f);
}

// kGw: threads of one group in a CTA (the group size, or 128 for groups of
// 128 and more). kSign: count anchor-segment crossings.
template <int kGw, bool kSign>
__global__ void __launch_bounds__(kThreads)
culled_blocks(const float* __restrict__ queries,
              const float* __restrict__ anchors,
              const float* __restrict__ rows, int n_blocks, int tb,
              const int* __restrict__ tbl, int n_groups, int n_slots,
              int group, float* __restrict__ d2_out,
              int* __restrict__ cnt_out) {
  __shared__ Tile s;
  const int lg = threadIdx.x / kGw;  // group slot in this CTA
  const int lane = threadIdx.x % kGw;
  long long g;
  size_t qi;
  if (group <= kThreads) {
    g = static_cast<long long>(blockIdx.x) * (kThreads / kGw) + lg;
    qi = static_cast<size_t>(g) * group + lane;
  } else {
    const int per = group / kThreads;  // CTAs per group
    g = blockIdx.x / per;
    qi = static_cast<size_t>(g) * group +
         static_cast<size_t>(blockIdx.x % per) * kThreads + threadIdx.x;
  }
  const bool valid = g < n_groups;
  const int base = lg * kGw;  // this group's slice of the shared tile
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  float dxx = 0.0f, dyy = 0.0f, dzz = 0.0f;
  if (valid) {
    qx = queries[3 * qi];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
    if constexpr (kSign) {
      dxx = anchors[3 * qi] - qx;
      dyy = anchors[3 * qi + 1] - qy;
      dzz = anchors[3 * qi + 2] - qz;
    }
  }
  const int* my_tbl = tbl + (valid ? static_cast<size_t>(g) * n_slots : 0);
  float run_min = kF32Max;
  int cnt = 0;

  for (int j = 0; j < n_slots; ++j) {
    const int blk = valid ? my_tbl[j] : n_blocks;
    const bool active = blk != n_blocks;
    // Pads are sorted last: once no group of the CTA has a block, stop.
    if (!__syncthreads_or(active)) break;
    const float* row = rows + static_cast<size_t>(blk) * 9 * tb;
    for (int start = 0; start < tb; start += kGw) {
      __syncthreads();  // the previous sub-tile has been consumed
      if (active) stage(s, base + lane, row, tb, start + lane);
      __syncthreads();
      if (!active) continue;
#pragma unroll 4
      for (int m = base; m < base + kGw; ++m) {
        const float apx = qx - s.f[kAx][m];
        const float apy = qy - s.f[kAy][m];
        const float apz = qz - s.f[kAz][m];
        min_dist2(s, m, apx, apy, apz, run_min);
        if constexpr (kSign)
          add_crossing(s, m, apx, apy, apz, dxx, dyy, dzz, cnt);
      }
    }
  }
  if (!valid) return;
  d2_out[qi] = run_min;
  if constexpr (kSign) cnt_out[qi] = cnt;
}

template <int kGw>
int launch(const float* q, const float* anchors, const float* rows,
           int n_blocks, int tb, const int* tbl, int n_groups, int n_slots,
           int group, float* d2, int* counts, cudaStream_t st) {
  long long ctas;
  if (group <= kThreads) {
    constexpr int gpc = kThreads / kGw;
    ctas = (static_cast<long long>(n_groups) + gpc - 1) / gpc;
  } else {
    ctas = static_cast<long long>(n_groups) * (group / kThreads);
  }
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ctas));
  if (anchors != nullptr) {
    culled_blocks<kGw, true><<<grid, kThreads, 0, st>>>(
        q, anchors, rows, n_blocks, tb, tbl, n_groups, n_slots, group, d2,
        counts);
  } else {
    culled_blocks<kGw, false><<<grid, kThreads, 0, st>>>(
        q, anchors, rows, n_blocks, tb, tbl, n_groups, n_slots, group, d2,
        counts);
  }
  return cudaGetLastError();
}

}  // namespace

// Per query (queries: (n_groups * group, 3) f32), the min squared distance
// over the triangles of its group's blocks (d2: (Q,) f32) and, when
// `anchors` ((Q, 3) f32) is not null, the query->anchor segment crossings
// (counts: (Q,) int32). rows: (n_blocks + 1, 9, tb) f32, tb a multiple of
// 128; tbl: (n_groups, n_slots) int32, pad id n_blocks after the real ones.
// group: 16, 32, 64 or a multiple of 128. Launches one kernel on `stream`,
// allocates nothing, returns the launch error (cudaSuccess = 0).
extern "C" int m2s_culled_blocks(const float* queries, const float* anchors,
                                 const float* rows, int n_blocks, int tb,
                                 const int* tbl, int n_groups, int n_slots,
                                 int group, float* d2, int* counts,
                                 void* stream) {
  if (n_groups <= 0) return cudaSuccess;
  if (tb <= 0 || tb % kThreads != 0 || n_slots <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 16:
      return launch<16>(queries, anchors, rows, n_blocks, tb, tbl, n_groups,
                        n_slots, group, d2, counts, st);
    case 32:
      return launch<32>(queries, anchors, rows, n_blocks, tb, tbl, n_groups,
                        n_slots, group, d2, counts, st);
    case 64:
      return launch<64>(queries, anchors, rows, n_blocks, tb, tbl, n_groups,
                        n_slots, group, d2, counts, st);
    default:
      if (group <= 0 || group % kThreads != 0) return cudaErrorInvalidValue;
      return launch<kThreads>(queries, anchors, rows, n_blocks, tb, tbl,
                              n_groups, n_slots, group, d2, counts, st);
  }
}
