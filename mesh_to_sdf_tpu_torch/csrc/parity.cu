// Line parity (grid raycast sign) for Hopper (sm_90a): a binned and a dense
// entry point over one hit pass and one scan.
//
// Replaces the TPU kernels `_parity_binned_kernel`
// (mesh_to_sdf_tpu/ops/kernels/pallas_parity.py:449), called through
// `line_parity_counts_binned` (pallas_parity.py:521), and `_parity_kernel`
// (pallas_parity.py:49), called through `line_parity_counts`
// (pallas_parity.py:135). The Python wrappers, the host-side
// `build_line_bins`, the chunk planner and the plain PyTorch versions live
// in mesh_to_sdf_tpu_torch/ops/kernels/parity.py.
//
// What it computes: for every +axis line l (transverse lattice n1 x n2,
// row-major) and every cell i along the axis, counts[l, i] = the number of
// triangles the ray from the cell-0 centre hits at a parameter t > 0 with
// floor(t * inv_cs) >= i. The hit test is the edge-function test of
// pallas_parity.py:85-107 and :480-500 (`den != 0`, `t > 0`, IEEE division),
// on the same pre-rotated planes. The binned entry groups lines in 32x32
// tiles; each tile visits only the 256-triangle blocks its `tbl` row lists
// (pad id = n_blocks is skipped). The dense entry tests every line against
// every triangle: it needs no host-built bins.
//
// What bounds it on the H100: a (line, triangle) pair that misses costs 15
// FP32 operations (the transverse offsets and three edge functions; the
// per-triangle edge e12 = ac - ab is computed once per staged triangle and
// thread) plus the sign compares; the tail (ax, abx, acx, the IEEE division,
// the bucket) runs only where the line passes inside the triangle, a few
// times per line. Over the candidate blocks of each tile (binned) or all T
// triangles (dense) that is bound by FP32 issue, not by bytes. The output,
// n_cells int32 per line (64 MB per axis at 256^3), is cleared, written
// where lines hit, and scanned once.
//
// What the design does about it:
// - The hit pass is a grid of (line groups) x (chunks of triangle blocks)
//   over gridDim.y: a CTA of kThreads threads owns kCtaLines lines, kR per
//   thread, and walks its chunk's 256-triangle blocks (dense: a contiguous
//   run of blocks of the zero-padded (9, Tp) planes; binned: a run of its
//   tile's `tbl` slots, each a block of `rows`). parity.py's planner
//   (`parity_chunks`) splits the blocks until the grid fills the card
//   several times over, so few lines (a 128^3 lattice, CULLED's 128 x 128
//   sign grid) still keep every SM busy with many warps.
// - Blocks are staged by cp.async into a double buffer (9 planes x 256
//   floats, 9 KB), the next block in flight while the current one is
//   tested. Each staged transverse value is read once per thread and serves
//   kR lines; the triangle loop is unrolled 4x, so the shared loads of the
//   next triangles overlap the current one's arithmetic. The tail runs
//   behind one warp-uniform vote per triangle.
// - A hit adds 1 by atomicAdd to the line's int32 histogram row: hits are
//   rare, integer sums do not depend on order, so every chunk count gives
//   the same bits. A hit with bucket b >= 0 adds 1 at min(b, n_cells - 1) (a
//   bucket past the last cell counts for every cell, as `cells <= m` does on
//   the TPU); a negative bucket (negative cell size) reaches no cell.
// - A second launch turns each row into suffix sums, one warp per row,
//   reading and writing each row coalesced, 8 loads of 32 cells in flight.
//   No K limit: the result is exact, and the caller reports zero overflow.
// - Lines past the lattice edge (the TPU's PAD_LINE padding) run with NaN
//   coordinates, which no edge test passes, so no lane needs a mask.
//
// Built with -fmad=false so the hit test rounds exactly as the plain version.

#include <cuda_runtime.h>

#include <cstddef>

#include "tri_record.cuh"

namespace {

constexpr int kThreads = 128;                // threads per hit-pass CTA
constexpr int kR = 4;                        // lines per thread
constexpr int kCtaLines = kThreads * kR;     // lines per CTA
constexpr int kTile = 32;                    // binned: lines per tile edge
constexpr int kTileLines = kTile * kTile;    // binned: lines per tile
constexpr int kSubs = kTileLines / kCtaLines;  // binned: CTAs per tile
constexpr int kBlock = 256;                  // triangles per staged block
constexpr int kPlanes = 9;                   // ax ay az abx aby abz acx acy acz
constexpr int kMinCtas = 8;                  // CTAs per SM the bounds ask for
constexpr int kScanThreads = 256;            // scan: 8 rows per CTA
constexpr int kScanBatch = 8;                // scan: chunks of 32 in flight
constexpr float kMiss = 3.0e38f;             // the TPU kernel's miss sentinel

static_assert(kTileLines % kCtaLines == 0, "a tile is whole CTAs");
static_assert(kThreads % kTile == 0, "a warp covers whole tile rows");

// The tail of a hit test whose edge functions w0, w1, w2 share a strict
// sign: the ray parameter, its bucket, and the histogram add for `line`.
// Triangle m of the staged block s (plane k at s[k * kBlock + m]). Each
// early return is a miss.
__device__ __forceinline__ void add_hit(int* __restrict__ counts,
                                       long long line, int n_cells,
                                       const float* s, int m, float w0,
                                       float w1, float w2, float ox,
                                       float inv_cs) {
  const float apx = ox - s[m];
  const float p1x = apx - s[3 * kBlock + m];
  const float p2x = apx - s[6 * kBlock + m];
  const float num = w0 * apx + w1 * p1x + w2 * p2x;
  const float den = w0 + w1 + w2;
  const float t = -num / (den == 0.0f ? 1.0f : den);
  if (!(t > 0.0f) || den == 0.0f) return;
  const float b = floorf(t * inv_cs);
  if (!(b >= 0.0f && b < kMiss)) return;
  const int i = b >= static_cast<float>(n_cells - 1) ? n_cells - 1
                                                     : static_cast<int>(b);
  atomicAdd(counts + line * n_cells + i, 1);
}

// Hit pass. Dense (kBinned false): line group blockIdx.x holds lines
// [blockIdx.x * kCtaLines, + kCtaLines) of L; unit j is block j of `planes`
// ((9, n_units * kBlock), plane stride `plane_stride`). Binned: line group
// blockIdx.x is half (kSubs) of tile blockIdx.x / kSubs of the t1 x t2
// tiles; unit j is slot j of the tile's `tbl` row, a block of `planes`
// (= rows, (n_blocks + 1, 9 * kBlock)), skipped if it is the pad id
// n_blocks. Chunk blockIdx.y walks units [blockIdx.y * chunk, + chunk).
template <bool kBinned>
__global__ void __launch_bounds__(kThreads, kMinCtas)
parity_hits(const float* __restrict__ oy, const float* __restrict__ oz,
            float ox, float inv_cs, const float* __restrict__ planes,
            long long block_stride, long long plane_stride,
            const int* __restrict__ tbl, int n_blocks, int n_units,
            int chunk, int t2, int n1, int n2, int L, int n_cells,
            int* __restrict__ counts) {
  __shared__ __align__(16) float ring[2][kPlanes * kBlock];
  const int tid = threadIdx.x;
  // Thread tid's lines are line0 + r * lstride, r < kR.
  long long line0, lstride;
  float py[kR], pz[kR];
  const float nan = __int_as_float(0x7fffffff);
  const int* slots = nullptr;
  if constexpr (kBinned) {
    const int tile = blockIdx.x / kSubs;
    const int sub = blockIdx.x - tile * kSubs;
    const int ti = tile / t2;
    const int tj = tile - ti * t2;
    // Local line sub * kCtaLines + r * kThreads + tid of the tile, row-major
    // over its 32 x 32 lines: row r0 + r * (kThreads / kTile), column c.
    const int r0 = ti * kTile + (sub * kCtaLines + tid) / kTile;
    const int c = tj * kTile + tid % kTile;
    if (ti * kTile + sub * (kCtaLines / kTile) >= n1) return;  // all past n1
    line0 = static_cast<long long>(r0) * n2 + c;
    lstride = static_cast<long long>(kThreads / kTile) * n2;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid = r0 + r * (kThreads / kTile) < n1 && c < n2;
      py[r] = valid ? oy[line0 + r * lstride] : nan;
      pz[r] = valid ? oz[line0 + r * lstride] : nan;
    }
    slots = tbl + static_cast<long long>(tile) * n_units;
  } else {
    line0 = static_cast<long long>(blockIdx.x) * kCtaLines + tid;
    lstride = kThreads;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid = line0 + r * lstride < L;
      py[r] = valid ? oy[line0 + r * lstride] : nan;
      pz[r] = valid ? oz[line0 + r * lstride] : nan;
    }
  }

  const int j0 = blockIdx.y * chunk;
  const int j1 = j0 + chunk < n_units ? j0 + chunk : n_units;
  // The first unit at or after j that holds a block (binned: not the pad
  // id; the same for the whole CTA).
  auto next_unit = [&](int j) {
    if constexpr (kBinned) {
      while (j < j1 && slots[j] == n_blocks) ++j;
    }
    return j;
  };
  // Unit j's block into ring[buf]; always one commit, so the wait below
  // counts groups the same way on every iteration.
  auto fetch = [&](int j, int buf) {
    if (j < j1) {
      const long long blk = kBinned ? slots[j] : j;
      const float* src = planes + blk * block_stride;
      for (int e = tid; e < kPlanes * (kBlock / 4); e += kThreads) {
        const int k = e / (kBlock / 4);
        const int f = 4 * (e - k * (kBlock / 4));
        tri::cp_async16(&ring[buf][k * kBlock + f],
                        src + k * plane_stride + f);
      }
    }
    tri::cp_async_commit();
  };

  int j = next_unit(j0);
  fetch(j, 0);
  for (int buf = 0; j < j1; buf ^= 1) {
    const int nxt = next_unit(j + 1);
    fetch(nxt, buf ^ 1);
    tri::cp_async_wait<1>();
    __syncthreads();  // block j has arrived for every thread
    const float* s = ring[buf];
#pragma unroll 4
    for (int m = 0; m < kBlock; ++m) {
      const float ay = s[kBlock + m], az = s[2 * kBlock + m];
      const float aby = s[4 * kBlock + m], abz = s[5 * kBlock + m];
      const float acy = s[7 * kBlock + m], acz = s[8 * kBlock + m];
      const float e12y = acy - aby;
      const float e12z = acz - abz;
      float w0[kR], w1[kR], w2[kR];
      bool inside[kR];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float apy = py[r] - ay;
        const float apz = pz[r] - az;
        const float p1y = apy - aby;
        const float p1z = apz - abz;
        const float p2y = apy - acy;
        const float p2z = apz - acz;
        w0[r] = p1z * e12y - p1y * e12z;
        w1[r] = p2z * (-acy) - p2y * (-acz);
        w2[r] = apz * aby - apy * abz;
        inside[r] = ((w0[r] < 0.0f) & (w1[r] < 0.0f) & (w2[r] < 0.0f)) |
                    ((w0[r] > 0.0f) & (w1[r] > 0.0f) & (w2[r] > 0.0f));
        any |= inside[r];
      }
      // A line passes inside a few triangles of all it meets: one
      // warp-uniform branch per triangle skips the tails.
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (inside[r])
            add_hit(counts, line0 + r * lstride, n_cells, s, m, w0[r], w1[r],
                    w2[r], ox, inv_cs);
      }
    }
    __syncthreads();  // every thread is done with ring[buf]
    j = nxt;
  }
}

// Suffix sums: warp w (of the grid) turns row w of `counts` (L rows of
// n_cells int32) into counts[w, i] = sum_{j >= i} counts[w, j], 32 cells
// (one chunk) at a time from the far end, carrying the running total. The
// loads of kScanBatch chunks are issued together, so a row costs one
// memory latency per batch, not per chunk.
__global__ void __launch_bounds__(kScanThreads)
parity_scan(int* __restrict__ counts, int L, int n_cells) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= L) return;  // the same for the whole warp
  int* rw = counts + w * n_cells;
  int carry = 0;
  for (int top = (n_cells - 1) / 32; top >= 0; top -= kScanBatch) {
    int v[kScanBatch];
#pragma unroll
    for (int b = 0; b < kScanBatch; ++b) {
      const int i = (top - b) * 32 + lane;
      v[b] = top - b >= 0 && i < n_cells ? rw[i] : 0;
    }
#pragma unroll
    for (int b = 0; b < kScanBatch; ++b) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_down_sync(0xffffffffu, v[b], off);
        if (lane + off < 32) v[b] += u;
      }
    }
#pragma unroll
    for (int b = 0; b < kScanBatch; ++b) {
      const int i = (top - b) * 32 + lane;
      v[b] += carry;
      if (top - b >= 0 && i < n_cells) rw[i] = v[b];
      carry = __shfl_sync(0xffffffffu, v[b], 0);
    }
  }
}

int launch_scan(int* counts, int L, int n_cells, cudaStream_t stream) {
  const long long ctas =
      (static_cast<long long>(L) * 32 + kScanThreads - 1) / kScanThreads;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  parity_scan<<<static_cast<unsigned>(ctas), kScanThreads, 0, stream>>>(
      counts, L, n_cells);
  return cudaGetLastError();
}

}  // namespace

// Crossing counts for +axis rays through per-tile candidate blocks.
// counts: (n1 * n2, n_cells) int32, zero on entry (the caller allocates and
// clears it). rows: (n_blocks + 1, 9 * tb) f32 packed planes, tb = 256;
// tbl: (t1 * t2, max_nb) int32 candidate block ids, split into chunks of
// `chunk` slots over gridDim.y (at most 65,535 chunks). Launches the hit
// pass and the scan on `stream`, allocates nothing, returns the first
// launch error (cudaSuccess = 0).
extern "C" int m2s_line_parity_binned(const float* oy, const float* oz,
                                      float ox, float inv_cs,
                                      const float* rows, const int* tbl,
                                      int n_blocks, int max_nb, int tb, int t1,
                                      int t2, int n1, int n2, int n_cells,
                                      int chunk, int* counts, void* stream) {
  if (t1 * t2 == 0 || n_cells <= 0) return cudaSuccess;
  if (tb != kBlock || chunk <= 0 || max_nb < 0) return cudaErrorInvalidValue;
  const int chunks = (max_nb + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (max_nb > 0) {
    const dim3 grid(static_cast<unsigned>(t1 * t2 * kSubs),
                    static_cast<unsigned>(chunks));
    parity_hits<true><<<grid, kThreads, 0, st>>>(
        oy, oz, ox, inv_cs, rows, kPlanes * kBlock, kBlock, tbl, n_blocks,
        max_nb, chunk, t2, n1, n2, n1 * n2, n_cells, counts);
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return launch_scan(counts, n1 * n2, n_cells, st);
}

// Crossing counts for +axis rays against every triangle. planes: (9, Tp)
// f32 pre-rotated planes (ax ay az abx aby abz acx acy acz), Tp a multiple
// of 256, triangles past the real ones all zero (they never pass the edge
// test); oy/oz: (L,) f32 line origins; counts: (L, n_cells) int32, zero on
// entry. The Tp / 256 blocks are split into chunks of `chunk` blocks over
// gridDim.y (at most 65,535). Launches the hit pass and the scan on
// `stream`, allocates nothing, returns the first launch error.
extern "C" int m2s_line_parity_dense(const float* oy, const float* oz,
                                     float ox, float inv_cs,
                                     const float* planes, long long Tp, int L,
                                     int n_cells, int chunk, int* counts,
                                     void* stream) {
  if (L == 0 || n_cells <= 0) return cudaSuccess;
  if (Tp % kBlock != 0 || chunk <= 0) return cudaErrorInvalidValue;
  const long long n_units = Tp / kBlock;
  const long long chunks = (n_units + chunk - 1) / chunk;
  if (n_units > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_units > 0) {
    const dim3 grid(static_cast<unsigned>((L + kCtaLines - 1) / kCtaLines),
                    static_cast<unsigned>(chunks));
    parity_hits<false><<<grid, kThreads, 0, st>>>(
        oy, oz, ox, inv_cs, planes, kBlock, Tp, nullptr, 0,
        static_cast<int>(n_units), chunk, 1, 0, 0, L, n_cells, counts);
    const int rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return launch_scan(counts, L, n_cells, st);
}

// The launch shape that parity.py's planner assumes, and what this card
// makes of it: out[0] lines per hit-pass CTA, out[1] triangles per block,
// out[2] CTAs per SM the launch bounds ask for, out[3] / out[4] the CTAs per
// SM the binned / dense hit pass can keep resident, out[5] threads per CTA.
// Returns the first CUDA error.
extern "C" int m2s_line_parity_shape(int* out) {
  out[0] = kCtaLines;
  out[1] = kBlock;
  out[2] = kMinCtas;
  out[5] = kThreads;
  int rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, parity_hits<true>, kThreads, 0);
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 4, parity_hits<false>, kThreads, 0);
}
