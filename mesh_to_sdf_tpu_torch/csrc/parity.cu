// Line parity (grid raycast sign) for Hopper (sm_90a): a binned and a dense
// entry point.
//
// Replaces the TPU kernels `_parity_binned_kernel`
// (mesh_to_sdf_tpu/ops/kernels/pallas_parity.py:449), called through
// `line_parity_counts_binned` (pallas_parity.py:521), and `_parity_kernel`
// (pallas_parity.py:49), called through `line_parity_counts`
// (pallas_parity.py:135). The Python wrappers, the host-side
// `build_line_bins` and the plain PyTorch versions live in
// mesh_to_sdf_tpu_torch/ops/kernels/parity.py.
//
// What it computes: for every +axis line l (transverse lattice n1 x n2,
// row-major) and every cell i along the axis, counts[l, i] = the number of
// triangles the ray from the cell-0 centre hits at a parameter t > 0 with
// floor(t * inv_cs) >= i. The hit test is the edge-function test of
// pallas_parity.py:85-107 and :480-500 (`den != 0`, `t > 0`, IEEE division),
// on the same pre-rotated planes. The binned kernel groups lines in 32x32
// tiles; each tile visits only the 256-triangle blocks its `tbl` row lists
// (pad id = n_blocks is skipped). The dense kernel tests every line against
// every triangle: it needs no host-built bins.
//
// What bounds it on the H100: the hit test is ~35 flops and one IEEE
// division per (line, triangle) pair, over the candidate blocks of each
// tile (binned) or over all T triangles (dense): compute-bound on FP32 and
// the divider. The output, n_cells int32 per line (64 MB per axis at
// 256^3), is written once and scanned once.
//
// What the design does about it: the TPU kernels avoided sorts and atomics
// by extracting the K smallest distinct hit buckets per (line, block), and
// counted what did not fit as `overflow`. Here each thread owns one line, so
// it can keep an exact histogram in its own output row. Binned: one CTA per
// tile, one thread per line, the block's 9 x 256 planes staged in shared
// memory (9 KB, broadcast reads). Dense: one CTA per 128 consecutive lines,
// the 9 planes of 128 triangles at a time staged in shared memory. A hit
// with bucket b >= 0 adds 1 at min(b, n_cells - 1) (a bucket past the last
// cell counts for every cell, as `cells <= m` does on the TPU); a negative
// bucket (negative cell size) reaches no cell. After the last triangle each
// warp turns its lines' histograms into suffix sums with warp shuffles,
// reading and writing each row coalesced. No atomics, no K limit: the result
// is exact, and the caller reports zero overflow. Lines past the lattice
// edge (the TPU's PAD_LINE padding) are masked. Both kernels add hits
// through count_hit, whose early returns act as the loop's `continue`: nvcc
// then unrolls the triangle loop 3x. A helper that returned the cell (or -1)
// for the caller to test kept the loop rolled and made the binned kernel
// ~25 % slower on an H100 (0.93 -> 1.18 ms per axis at 128^3).
//
// Built with -fmad=false so the hit test rounds exactly as the plain version.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;                 // lines per tile edge
constexpr int kThreads = kTile * kTile;   // one thread per line of a tile
constexpr int kDenseThreads = 128;        // dense: lines per CTA
constexpr int kDenseTile = 128;           // dense: triangles staged per tile
constexpr float kMiss = 3.0e38f;          // the TPU kernel's miss sentinel

// Adds the hit of line (py, pz) on triangle m, if there is one, to the
// line's histogram row. planes[k * stride + m] holds plane k (ax ay az abx
// aby abz acx acy acz, x = the ray axis) of triangle m. Each early return
// reads as the caller's `continue`.
__device__ __forceinline__ void count_hit(int* row, const float* planes,
                                          int stride, int m, float py,
                                          float pz, float ox, float inv_cs,
                                          int n_cells) {
  const float ax = planes[m], ay = planes[stride + m],
              az = planes[2 * stride + m];
  const float abx = planes[3 * stride + m], aby = planes[4 * stride + m],
              abz = planes[5 * stride + m];
  const float acx = planes[6 * stride + m], acy = planes[7 * stride + m],
              acz = planes[8 * stride + m];
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
  if (!inside) return;
  const float apx = ox - ax;
  const float p1x = apx - abx;
  const float p2x = apx - acx;
  const float num = w0 * apx + w1 * p1x + w2 * p2x;
  const float den = w0 + w1 + w2;
  const float t = -num / (den == 0.0f ? 1.0f : den);
  if (!(t > 0.0f) || den == 0.0f) return;
  const float b = floorf(t * inv_cs);
  if (b >= 0.0f && b < kMiss) {
    const int i = b >= static_cast<float>(n_cells - 1)
                      ? n_cells - 1
                      : static_cast<int>(b);
    row[i] += 1;
  }
}

// One warp turns the histogram row rw (n_cells int32) into suffix sums, 32
// cells at a time from the far end, carrying the running total.
__device__ __forceinline__ void suffix_sum_row(int* rw, int n_cells,
                                               int lane) {
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
      count_hit(row, planes, tb, m, py, pz, ox, inv_cs, n_cells);
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
    suffix_sum_row(counts + (static_cast<size_t>(rr) * n2 + cc) * n_cells,
                   n_cells, lane);
  }
}

__global__ void __launch_bounds__(kDenseThreads)
parity_dense(const float* __restrict__ oy, const float* __restrict__ oz,
             float ox, float inv_cs, const float* __restrict__ tri_planes,
             int T, int L, int n_cells, int* __restrict__ counts) {
  __shared__ float planes[9 * kDenseTile];  // 9 planes of kDenseTile tris
  const int line = blockIdx.x * kDenseThreads + threadIdx.x;
  const bool valid = line < L;
  const float py = valid ? oy[line] : 0.0f;
  const float pz = valid ? oz[line] : 0.0f;
  int* row = counts + static_cast<size_t>(line) * n_cells;

  for (int start = 0; start < T; start += kDenseTile) {
    __syncthreads();  // previous tile consumed
    for (int k = threadIdx.x; k < 9 * kDenseTile; k += kDenseThreads) {
      const int plane = k / kDenseTile;
      const int m = k - plane * kDenseTile;
      planes[k] = start + m < T
                      ? tri_planes[static_cast<size_t>(plane) * T + start + m]
                      : 0.0f;
    }
    __syncthreads();
    if (!valid) continue;
    const int n = T - start < kDenseTile ? T - start : kDenseTile;
    for (int m = 0; m < n; ++m) {
      count_hit(row, planes, kDenseTile, m, py, pz, ox, inv_cs, n_cells);
    }
  }
  __syncthreads();  // every line's histogram is complete

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int l = warp; l < kDenseThreads; l += kDenseThreads / 32) {
    const int ln = blockIdx.x * kDenseThreads + l;
    if (ln >= L) continue;  // same for the whole warp
    suffix_sum_row(counts + static_cast<size_t>(ln) * n_cells, n_cells,
                   lane);
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

// Crossing counts for +axis rays against every triangle. tri_planes: (9, T)
// f32 pre-rotated planes (ax ay az abx aby abz acx acy acz); oy/oz: (L,) f32
// line origins; counts: (L, n_cells) int32, zero on entry. Launches one
// kernel on `stream`, allocates nothing, returns the launch error.
extern "C" int m2s_line_parity_dense(const float* oy, const float* oz,
                                     float ox, float inv_cs,
                                     const float* tri_planes, int T, int L,
                                     int n_cells, int* counts, void* stream) {
  if (L == 0 || n_cells <= 0) return cudaSuccess;
  const int blocks = (L + kDenseThreads - 1) / kDenseThreads;
  parity_dense<<<blocks, kDenseThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      oy, oz, ox, inv_cs, tri_planes, T, L, n_cells, counts);
  return cudaGetLastError();
}
