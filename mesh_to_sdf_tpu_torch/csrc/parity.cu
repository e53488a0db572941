// Binned line parity (grid raycast sign) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_parity_binned_kernel`
// (mesh_to_sdf_tpu/ops/kernels/pallas_parity.py:449), called through
// `line_parity_counts_binned` (pallas_parity.py:521). The Python wrapper,
// the host-side `build_line_bins` and the plain PyTorch version live in
// mesh_to_sdf_tpu_torch/ops/kernels/parity.py.
//
// What it computes: for every +axis line l (transverse lattice n1 x n2,
// row-major) and every cell i along the axis, counts[l, i] = the number of
// triangles the ray from the cell-0 centre hits at a parameter t > 0 with
// floor(t * inv_cs) >= i. The hit test is the edge-function test of
// pallas_parity.py:480-500 (`den != 0`, `t > 0`), on the same pre-rotated
// planes. Lines are grouped in 32x32 tiles; each tile visits only the
// 256-triangle blocks its `tbl` row lists (pad id = n_blocks is skipped).
//
// What bounds it on the H100: the hit test is ~35 flops and one IEEE
// division per (line, triangle) pair, over the candidate blocks of each
// tile: compute-bound on FP32 and the divider. The output, n_cells int32 per
// line (64 MB per axis at 256^3), is written once and scanned once.
//
// What the design does about it: the TPU kernel avoided sorts and atomics by
// extracting the K smallest distinct hit buckets per (line, block), and
// counted what did not fit as `overflow`. Here each thread owns one line, so
// it can keep an exact histogram in its own output row: one CTA per tile,
// one thread per line, the block's 9 x 256 planes staged in shared memory
// (9 KB, broadcast reads). A hit with bucket b >= 0 adds 1 at
// min(b, n_cells - 1); a negative bucket (negative cell size) reaches no
// cell, as `cells <= m` gives on the TPU. After the last block each warp
// turns its lines' histograms into suffix sums with warp shuffles, reading
// and writing each row coalesced. No atomics, no K limit: the result is
// exact, and the caller reports zero overflow. Lines past the lattice edge
// (the TPU's PAD_LINE padding) are masked.
//
// Built with -fmad=false so the hit test rounds exactly as the plain version.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;                 // lines per tile edge
constexpr int kThreads = kTile * kTile;   // one thread per line of a tile
constexpr float kMiss = 3.0e38f;          // the TPU kernel's miss sentinel

__global__ void __launch_bounds__(kThreads)
parity_binned(const float* __restrict__ oy, const float* __restrict__ oz,
              float ox, float inv_cs, const float* __restrict__ rows,
              const int* __restrict__ tbl, int n_blocks, int max_nb, int tb,
              int t2, int n1, int n2, int n_cells, int* __restrict__ counts) {
  extern __shared__ float planes[];  // 9 * tb: ax ay az abx aby abz acx acy acz
  const int tile = blockIdx.x;
  const int ti = tile / t2;
  const int tj = tile - ti * t2;
  const int r = ti * kTile + threadIdx.x / kTile;
  const int c = tj * kTile + threadIdx.x % kTile;
  const bool valid = r < n1 && c < n2;
  const size_t line = static_cast<size_t>(r) * n2 + c;
  const float py = valid ? oy[line] : 0.0f;
  const float pz = valid ? oz[line] : 0.0f;
  int* row = counts + line * n_cells;

  const int* slots = tbl + static_cast<size_t>(tile) * max_nb;
  for (int j = 0; j < max_nb; ++j) {
    const int slot = slots[j];
    if (slot == n_blocks) continue;  // pad id: same for the whole CTA
    __syncthreads();                 // previous block's planes consumed
    const float* src = rows + static_cast<size_t>(slot) * 9 * tb;
    for (int k = threadIdx.x; k < 9 * tb; k += blockDim.x) planes[k] = src[k];
    __syncthreads();
    if (!valid) continue;
    for (int m = 0; m < tb; ++m) {
      const float ax = planes[m], ay = planes[tb + m], az = planes[2 * tb + m];
      const float abx = planes[3 * tb + m], aby = planes[4 * tb + m],
                  abz = planes[5 * tb + m];
      const float acx = planes[6 * tb + m], acy = planes[7 * tb + m],
                  acz = planes[8 * tb + m];
      const float apy = py - ay;
      const float apz = pz - az;
      const float p1y = apy - aby;
      const float p1z = apz - abz;
      const float p2y = apy - acy;
      const float p2z = apz - acz;
      const float e12y = acy - aby;
      const float e12z = acz - abz;
      const float w0 = p1z * e12y - p1y * e12z;
      const float w1 = p2z * (-acy) - p2y * (-acz);
      const float w2 = apz * aby - apy * abz;
      const bool inside = ((w0 < 0.0f) & (w1 < 0.0f) & (w2 < 0.0f)) |
                          ((w0 > 0.0f) & (w1 > 0.0f) & (w2 > 0.0f));
      if (!inside) continue;
      const float apx = ox - ax;
      const float p1x = apx - abx;
      const float p2x = apx - acx;
      const float num = w0 * apx + w1 * p1x + w2 * p2x;
      const float den = w0 + w1 + w2;
      const float t = -num / (den == 0.0f ? 1.0f : den);
      if (!(t > 0.0f) || den == 0.0f) continue;
      const float b = floorf(t * inv_cs);
      if (b >= 0.0f && b < kMiss) {
        const int i = b >= static_cast<float>(n_cells - 1)
                          ? n_cells - 1
                          : static_cast<int>(b);
        row[i] += 1;
      }
    }
  }
  __syncthreads();  // every line's histogram is complete

  // Suffix sums: warp w scans the rows of lines w, w + 32, ... of the tile,
  // 32 cells at a time from the far end, carrying the running total.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int l = warp; l < kThreads; l += kThreads / 32) {
    const int rr = ti * kTile + l / kTile;
    const int cc = tj * kTile + l % kTile;
    if (rr >= n1 || cc >= n2) continue;  // same for the whole warp
    int* rw = counts + (static_cast<size_t>(rr) * n2 + cc) * n_cells;
    int carry = 0;
    for (int start = ((n_cells - 1) / 32) * 32; start >= 0; start -= 32) {
      const int i = start + lane;
      int v = i < n_cells ? rw[i] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_down_sync(0xffffffffu, v, off);
        if (lane + off < 32) v += u;
      }
      v += carry;
      if (i < n_cells) rw[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 0);
    }
  }
}

}  // namespace

// Crossing counts for +axis rays through per-tile candidate blocks.
// counts: (n1 * n2, n_cells) int32, zero on entry (the caller allocates and
// clears it). rows: (n_blocks + 1, 9 * tb) f32 packed planes; tbl:
// (t1 * t2, max_nb) int32 candidate block ids. Launches one kernel on
// `stream`, allocates nothing, returns the launch error (cudaSuccess = 0).
extern "C" int m2s_line_parity_binned(const float* oy, const float* oz,
                                      float ox, float inv_cs,
                                      const float* rows, const int* tbl,
                                      int n_blocks, int max_nb, int tb, int t1,
                                      int t2, int n1, int n2, int n_cells,
                                      int* counts, void* stream) {
  if (t1 * t2 == 0 || n_cells <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(9) * tb * sizeof(float);
  parity_binned<<<t1 * t2, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      oy, oz, ox, inv_cs, rows, tbl, n_blocks, max_nb, tb, t2, n1, n2,
      n_cells, counts);
  return cudaGetLastError();
}
