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
// pallas_sdf._closest_point_vw + _dist2, tri::dist2), and, given anchors,
// the number of strict-interior Moller-Trumbore crossings of the segment
// from the query to its anchor (pallas_culled.py:567-591). The blocks come
// as packed records (csrc/tri_record.cuh), tb per block, packed once per
// block table of a mesh (culled.table_records).
//
// What bounds it on the H100: each (query, triangle) pair costs ~53 FP32
// operations for the ladder and ~43 more for the crossing test; each block
// (20 KB of records) is read by every query of a group that lists it. At 1M
// queries, 32 blocks of 256 per query, that is 8.2e9 pairs, ~0.8e12
// operations: bound by FP32 issue (33.5e12 separately rounded operations/s
// at 700 W, -fmad=false), not by the bytes.
//
// What the design does about it: a team of kTeam threads owns one slice of
// kTeam * kR queries of a group (kR per thread, so one record read from
// shared memory serves kR pairs) and walks its group's slots on its own:
// - st 16 and 32: a team is a half-warp or a warp (st 64: a warp with two
//   queries per thread). It copies its block's records chunk by chunk
//   (cp.async, no arithmetic) into its own double-buffered slice of shared
//   memory, synchronises with __syncwarp only, and stops at its first pad
//   slot by a warp vote, so the warps of a CTA advance independently;
// - groups of 128 and more (the union engine): a team is the whole CTA
//   with two queries per thread where the group allows, 128 triangles per
//   chunk, one barrier per chunk.
// The running min and count stay in registers; the slot loop is the TPU
// kernel's pl.when(slot != n_blocks). 1/det is __frcp_rn, the correctly
// rounded reciprocal, so it equals the plain version's IEEE 1/det.
//
// Built with -fmad=false so every operation rounds as the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

#include "tri_record.cuh"

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr unsigned kFull = 0xffffffffu;

// Adds 1 to `cnt` if the segment q -> q + (dxx, dyy, dzz) crosses the
// triangle strictly inside (culled.segment_crossings).
__device__ __forceinline__ void add_crossing(const tri::Record& t, float apx,
                                             float apy, float apz, float dxx,
                                             float dyy, float dzz, int& cnt) {
  const float abx = t.r1.x, aby = t.r1.y, abz = t.r1.z;
  const float acx = t.r2.x, acy = t.r2.y, acz = t.r2.z;
  const float pvx = dyy * acz - dzz * acy;
  const float pvy = dzz * acx - dxx * acz;
  const float pvz = dxx * acy - dyy * acx;
  const float det = abx * pvx + aby * pvy + abz * pvz;
  const float inv = det == 0.0f ? 0.0f : __frcp_rn(det);
  const float u = (apx * pvx + apy * pvy + apz * pvz) * inv;
  const float qvx = apy * abz - apz * aby;
  const float qvy = apz * abx - apx * abz;
  const float qvz = apx * aby - apy * abx;
  const float vv = (dxx * qvx + dyy * qvy + dzz * qvz) * inv;
  const float tt = (acx * qvx + acy * qvy + acz * qvz) * inv;
  cnt += (det != 0.0f && u > 0.0f && vv > 0.0f && u + vv < 1.0f &&
          tt > 0.0f && tt < 1.0f);
}

// kTeam: threads that share one group slice (16, 32 or kThreads). kR:
// queries per thread. kSign: count anchor-segment crossings. A group of
// `group` queries is group / (kTeam * kR) consecutive slices.
template <int kTeam, int kR, bool kSign>
__global__ void __launch_bounds__(kThreads)
culled_blocks(const float* __restrict__ queries,
              const float* __restrict__ anchors,
              const float4* __restrict__ rec, int n_blocks, int tb,
              const int* __restrict__ tbl, int n_groups, int n_slots,
              int slices, float* __restrict__ d2_out,
              int* __restrict__ cnt_out) {
  constexpr int kTeams = kThreads / kTeam;  // teams per CTA
  // Triangles per staged chunk: each thread copies 10 (5 for the CTA team)
  // of the chunk's 16-byte pieces.
  constexpr int kChunk = kTeam == kThreads ? kThreads : 2 * kTeam;
  constexpr int kPieces = kChunk * tri::kRecF4;
  __shared__ __align__(16) float4 ring[kTeams][2][kPieces];
  const int lt = threadIdx.x / kTeam;  // team in this CTA
  const int lane = threadIdx.x % kTeam;
  const long long team = static_cast<long long>(blockIdx.x) * kTeams + lt;
  const long long g = team / slices;
  const bool valid = g < n_groups;
  const size_t q0 = static_cast<size_t>(team) * (kTeam * kR) + lane;
  float qx[kR], qy[kR], qz[kR], dx[kR], dy[kR], dz[kR], run_min[kR];
  int cnt[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t qi = q0 + static_cast<size_t>(r) * kTeam;
    qx[r] = valid ? queries[3 * qi] : 0.0f;
    qy[r] = valid ? queries[3 * qi + 1] : 0.0f;
    qz[r] = valid ? queries[3 * qi + 2] : 0.0f;
    dx[r] = dy[r] = dz[r] = 0.0f;
    if constexpr (kSign) {
      if (valid) {
        dx[r] = anchors[3 * qi] - qx[r];
        dy[r] = anchors[3 * qi + 1] - qy[r];
        dz[r] = anchors[3 * qi + 2] - qz[r];
      }
    }
    run_min[r] = tri::kF32Max;
    cnt[r] = 0;
  }
  const int* row = tbl + (valid ? static_cast<size_t>(g) * n_slots : 0);
  const int n_chunks = tb / kChunk;

  // Chunk c of block blk into buffer `buf` of this team; one commit always.
  auto fetch = [&](int buf, int blk, int c) {
    if (blk != n_blocks) {
      const float4* src =
          rec + (static_cast<size_t>(blk) * tb + c * kChunk) * tri::kRecF4;
      float4* dst = ring[lt][buf];
#pragma unroll
      for (int e = lane; e < kPieces; e += kTeam)
        tri::cp_async16(dst + e, src + e);
    }
    tri::cp_async_commit();
  };
  auto team_sync = [] {
    if constexpr (kTeam == kThreads) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  };

  // Pads are sorted last, so a team is done at its first pad slot. The CTA
  // team reads one slot list, so `blk` is the same in all its threads; the
  // warp teams loop while a lane of the warp has a block.
  int j = 0, c = 0;
  int blk = valid ? row[0] : n_blocks;
  fetch(0, blk, 0);
  for (int it = 0;; ++it) {
    const bool active = blk != n_blocks;
    if constexpr (kTeam == kThreads) {
      if (!active) break;
    } else {
      if (!__any_sync(kFull, active)) break;
    }
    int c1 = c + 1, j1 = j, blk1 = blk;
    if (c1 == n_chunks) {
      c1 = 0;
      j1 = j + 1;
      blk1 = active && j1 < n_slots ? row[j1] : n_blocks;
    }
    tri::cp_async_wait<0>();
    team_sync();  // chunk `it` has arrived; the team is done with `it - 1`
    fetch((it + 1) & 1, blk1, c1);
    if (active) {
      const float4* s = ring[lt][it & 1];
#pragma unroll 2
      for (int m = 0; m < kChunk; ++m) {
        const tri::Record t = tri::load(s, m);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float apx = qx[r] - t.r0.x;
          const float apy = qy[r] - t.r0.y;
          const float apz = qz[r] - t.r0.z;
          const float dd = tri::dist2(t, apx, apy, apz);
          run_min[r] = dd < run_min[r] ? dd : run_min[r];
          if constexpr (kSign)
            add_crossing(t, apx, apy, apz, dx[r], dy[r], dz[r], cnt[r]);
        }
      }
    }
    c = c1;
    j = j1;
    blk = blk1;
  }
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t qi = q0 + static_cast<size_t>(r) * kTeam;
    d2_out[qi] = run_min[r];
    if constexpr (kSign) cnt_out[qi] = cnt[r];
  }
}

template <int kTeam, int kR>
int launch(const float* q, const float* anchors, const float4* rec,
           int n_blocks, int tb, const int* tbl, int n_groups, int n_slots,
           int group, float* d2, int* counts, cudaStream_t st) {
  constexpr int kTeams = kThreads / kTeam;
  const int slices = group / (kTeam * kR);
  const long long teams = static_cast<long long>(n_groups) * slices;
  const long long ctas = (teams + kTeams - 1) / kTeams;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ctas));
  if (anchors != nullptr) {
    culled_blocks<kTeam, kR, true><<<grid, kThreads, 0, st>>>(
        q, anchors, rec, n_blocks, tb, tbl, n_groups, n_slots, slices, d2,
        counts);
  } else {
    culled_blocks<kTeam, kR, false><<<grid, kThreads, 0, st>>>(
        q, anchors, rec, n_blocks, tb, tbl, n_groups, n_slots, slices, d2,
        counts);
  }
  return cudaGetLastError();
}

}  // namespace

// Per query (queries: (n_groups * group, 3) f32), the min squared distance
// over the triangles of its group's blocks (d2: (Q,) f32) and, when
// `anchors` ((Q, 3) f32) is not null, the query->anchor segment crossings
// (counts: (Q,) int32). rec: (n_blocks + 1, tb, 20) f32 packed records
// (csrc/tri_record.cuh), tb a multiple of 128, the pad block last; tbl:
// (n_groups, n_slots) int32, pad id n_blocks after the real ones. group:
// 16, 32, 64 or a multiple of 128. Launches one kernel on `stream`,
// allocates nothing, returns the launch error (cudaSuccess = 0).
extern "C" int m2s_culled_blocks(const float* queries, const float* anchors,
                                 const float* rec, int n_blocks, int tb,
                                 const int* tbl, int n_groups, int n_slots,
                                 int group, float* d2, int* counts,
                                 void* stream) {
  if (n_groups <= 0) return cudaSuccess;
  if (tb <= 0 || tb % kThreads != 0 || n_slots <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  switch (group) {
    case 16:
      return launch<16, 1>(queries, anchors, r4, n_blocks, tb, tbl, n_groups,
                           n_slots, group, d2, counts, st);
    case 32:
      return launch<32, 1>(queries, anchors, r4, n_blocks, tb, tbl, n_groups,
                           n_slots, group, d2, counts, st);
    case 64:
      return launch<32, 2>(queries, anchors, r4, n_blocks, tb, tbl, n_groups,
                           n_slots, group, d2, counts, st);
    default:
      if (group <= 0 || group % kThreads != 0) return cudaErrorInvalidValue;
      if (group % (2 * kThreads) == 0)
        return launch<kThreads, 2>(queries, anchors, r4, n_blocks, tb, tbl,
                                   n_groups, n_slots, group, d2, counts, st);
      return launch<kThreads, 1>(queries, anchors, r4, n_blocks, tb, tbl,
                                 n_groups, n_slots, group, d2, counts, st);
  }
}
