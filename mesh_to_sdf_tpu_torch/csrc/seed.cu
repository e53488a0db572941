// CPT seed for Hopper (sm_90a): every cell's best and runner-up distinct
// triangles from the host-built seed bins.
//
// Replaces the JAX package's `seed_from_bins`
// (mesh_to_sdf_tpu/ops/cpt.py:421), XLA glue on the TPU with no Pallas
// kernel behind it. The Python wrapper lives in
// mesh_to_sdf_tpu_torch/ops/kernels/seed.py; the plain PyTorch version
// (seed_from_bins_plain there) is the eager computation this kernel is held
// bit-equal to.
//
// What it computes: the bins list each seeded cell's candidate triangles in
// ceil(c / K) consecutive rows of K slots (entry (K, R), slot-major;
// rows_cell (R,) the cell of each row, N for a padding row; cell_row (N,)
// each cell's first row, -1 for none; id T marks a padding slot). Each slot
// is evaluated exactly at the cell centre first_cell + index * cell_size
// (multiply, then add) with the closest-point ladder on the triangle's
// packed record (tri::dist2, then the correctly rounded sqrtf), as the
// sweep does. A row keeps its first minimum in slot order and, among the
// slots whose id differs from it, the first minimum (the plain version's
// two argmins; a padding slot reads F32_MAX). The rows of a cell are then
// merged in the plain version's shifted-merge tree: round s merges row r
// with row r + 2^s of the same cell, so the first row ends as a balanced
// tree over its first 2^n_rounds rows, a missing partner skipped. Each
// merge is _combine_top2's: the earlier rows win ties for best, and the
// runner-up is the first minimum of [loser's best, earlier runner-up, later
// runner-up] among the ids that differ from the new best. Ids paired with
// F32_MAX never reach the output: a distance of F32_MAX or an id of T or
// more becomes the sentinel (F32_MAX, -1), as does an unseeded cell.
//
// What bounds it on the H100: each input is read once and each output
// written once: cell_row and the four (N,) outputs (20 B a cell), the
// seeded rows' slots and cells (36 B a row at K = 8), the records from L2.
// At the 256^3 grid of icosphere(5) that is ~411 MB, 0.12 ms at 3.35 TB/s;
// the ladder's ~54 operations per slot add ~0.03 ms. Memory bounds it.
//
// What the design does about it: one thread per cell, one launch, no
// intermediate in device memory. Consecutive cells take consecutive
// threads, so the reads of cell_row and the writes of the outputs are
// coalesced; the seeded cells of a warp own consecutive rows, so their
// slot reads are too. An unseeded cell (93% at 256^3) reads 4 B and writes
// 16 B. A cell's rows are combined as its leaves arrive, with a binary
// counter over a stack of pending subtrees in local memory (touched only
// by a cell of two rows or more: 0.6 % of the seeded cells at 256^3),
// which is the shifted-merge tree without its (R,) rounds.
//
// Built with -fmad=false so the ladder and the cell centre round as the
// plain version's.

#include <cuda_runtime.h>

#include "tri_record.cuh"

namespace {

constexpr int kThreads = 256;
// Deepest merge tree (rows per cell up to 2^kMaxRounds).
constexpr int kMaxRounds = 30;

struct Top2 {
  float d1;
  int i1;
  float d2;
  int i2;
};

// _combine_top2 of an earlier (a) and a later (b) pair.
__device__ __forceinline__ Top2 combine(const Top2& a, const Top2& b) {
  const bool a_first = a.d1 <= b.d1;
  Top2 o;
  o.d1 = a_first ? a.d1 : b.d1;
  o.i1 = a_first ? a.i1 : b.i1;
  const float cd[3] = {a_first ? b.d1 : a.d1, a.d2, b.d2};
  const int ci[3] = {a_first ? b.i1 : a.i1, a.i2, b.i2};
  o.d2 = ci[0] == o.i1 ? tri::kF32Max : cd[0];
  o.i2 = ci[0];
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const float d = ci[k] == o.i1 ? tri::kF32Max : cd[k];
    if (d < o.d2) {
      o.d2 = d;
      o.i2 = ci[k];
    }
  }
  return o;
}

// One row's top two: slot 0 first, then each later slot merged in order
// (the two argmins of the plain version: the first minimum, then the first
// minimum among the other ids; one id has one distance in a cell, so a
// slot that ties the best is its own id or comes after it).
__device__ __forceinline__ Top2 leaf(const int* __restrict__ entry,
                                     const float4* __restrict__ rec, int T,
                                     int K, long long R, long long r, float px,
                                     float py, float pz) {
  Top2 t{tri::kF32Max, T, tri::kF32Max, T};
  for (int k = 0; k < K; ++k) {
    const int id = __ldg(entry + k * R + r);
    float d = tri::kF32Max;
    if (id >= 0 && id < T) {
      const float4* p = rec + static_cast<long long>(id) * tri::kRecF4;
      const tri::Record t_rec{__ldg(p), __ldg(p + 1), __ldg(p + 2),
                              __ldg(p + 3), __ldg(p + 4)};
      d = sqrtf(tri::dist2(t_rec, px - t_rec.r0.x, py - t_rec.r0.y,
                           pz - t_rec.r0.z));
    }
    if (k == 0) {
      t.d1 = d;
      t.i1 = id;
    } else if (d < t.d1) {
      if (id != t.i1) {
        t.d2 = t.d1;
        t.i2 = t.i1;
      }
      t.d1 = d;
      t.i1 = id;
    } else if (id != t.i1 && d < t.d2) {
      t.d2 = d;
      t.i2 = id;
    }
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
seed_cells(const int* __restrict__ entry, const int* __restrict__ rows_cell,
           const int* __restrict__ cell_row, const float4* __restrict__ rec,
           int T, int K, long long R, int nx, int ny, int nz, int n_rounds,
           float f0, float f1, float f2, float c0, float c1, float c2,
           float* __restrict__ d1, int* __restrict__ i1,
           float* __restrict__ d2, int* __restrict__ i2) {
  const long long n = static_cast<long long>(nx) * ny * nz;
  const long long c =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= n) return;
  const int r0 = __ldg(cell_row + c);
  Top2 out{tri::kF32Max, -1, tri::kF32Max, -1};
  if (r0 >= 0) {
    const int cell = static_cast<int>(c);
    const int z = cell % nz, y = (cell / nz) % ny, x = cell / (ny * nz);
    const float px = f0 + static_cast<float>(x) * c0;
    const float py = f1 + static_cast<float>(y) * c1;
    const float pz = f2 + static_cast<float>(z) * c2;
    // The rows the tree reaches: consecutive rows of this cell, at most
    // 2^n_rounds of them.
    const long long max_rows = 1LL << n_rounds;
    long long m = 1;
    while (m < max_rows && r0 + m < R && __ldg(rows_cell + r0 + m) == cell)
      ++m;
    out = leaf(entry, rec, T, K, R, r0, px, py, pz);
    if (m > 1) {
      // Binary counter: stack[l] holds a complete subtree of 2^l leaves
      // waiting for its right partner while bit l of `pending` is set.
      Top2 stack[kMaxRounds + 1];
      unsigned pending = 1u;
      stack[0] = out;
      for (long long j = 1; j < m; ++j) {
        Top2 v = leaf(entry, rec, T, K, R, r0 + j, px, py, pz);
        int l = 0;
        while (pending >> l & 1u) {
          v = combine(stack[l], v);
          pending &= ~(1u << l);
          ++l;
        }
        stack[l] = v;
        pending |= 1u << l;
      }
      // The unpaired subtrees, the latest first: each earlier one is the
      // left side of the next merge up (a missing partner is skipped).
      bool have = false;
      for (int l = 0; l <= kMaxRounds; ++l) {
        if (!(pending >> l & 1u)) continue;
        out = have ? combine(stack[l], out) : stack[l];
        have = true;
      }
    }
    if (out.i1 >= T || out.d1 >= tri::kF32Max) out.i1 = -1;
    if (out.i2 >= T || out.d2 >= tri::kF32Max) out.i2 = -1;
  }
  d1[c] = out.d1;
  i1[c] = out.i1;
  d2[c] = out.d2;
  i2[c] = out.i2;
}

}  // namespace

// Every cell's (d1, i1, d2, i2) of the nx x ny x nz grid (x-major, z
// fastest) from the seed bins entry (K, R) int32, rows_cell (R,) int32,
// cell_row (nx ny nz,) int32 and n_rounds, reading triangle `id` as record
// `id` of rec (T + 1 packed records; ids outside [0, T) are padding).
// first/size: world (x, y, z) grid parameters. Writes the four flat outputs
// once on `stream` with one launch, allocates nothing, returns the first
// error (cudaSuccess = 0).
extern "C" int m2s_seed_from_bins(const int* entry, const int* rows_cell,
                                  const int* cell_row, const float* rec,
                                  int T, int K, long long R, int nx, int ny,
                                  int nz, int n_rounds, float f0, float f1,
                                  float f2, float c0, float c1, float c2,
                                  float* d1, int* i1, float* d2, int* i2,
                                  void* stream) {
  if (T < 0 || K < 1 || R < 1 || n_rounds < 0 || n_rounds > kMaxRounds ||
      nx < 0 || ny < 0 || nz < 0)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n == 0) return cudaSuccess;
  if (n >= (1LL << 31) - 1) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  seed_cells<<<blocks, kThreads, 0, st>>>(
      entry, rows_cell, cell_row, reinterpret_cast<const float4*>(rec), T, K,
      R, nx, ny, nz, n_rounds, f0, f1, f2, c0, c1, c2, d1, i1, d2, i2);
  return cudaGetLastError();
}
