// Directional closest-point-transform sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel`
// (mesh_to_sdf_tpu/ops/kernels/pallas_sweep.py:142), called through
// `sweep_oriented` (pallas_sweep.py:269). The Python wrapper and the plain
// PyTorch version live in mesh_to_sdf_tpu_torch/ops/kernels/sweep.py.
//
// What it computes: the state is four x-first (nx, ny, nz) volumes, each
// cell's two best distinct triangles (d1, i1) and (d2, i2); a triangle is
// read as its packed record (csrc/tri_record.cuh) by id, id -1 as the PAD
// record at index T (vertices at PAD_COORD). One sweep walks the slices
// along `axis` (reversed or not); each cell of slice s merges 18
// candidates: both slots of the 3x3 window of slice s -/+ 1, each evaluated
// exactly at the cell centre with the division-free closest-point ladder
// (`_pt_dist2`, pallas_sweep.py:42; tri::dist2 on a record rounds as that
// ladder on the vertices does). Candidates are merged in the TPU kernel's
// order (window rows, then columns, then slot 1 before slot 2; rows and
// columns are the plane's lower and higher world axes) with the same strict
// `<` tests, so ties resolve the same way. Edge cells and the first slice
// get sentinel candidates (id -1), as the TPU kernel's margins and column
// masks give.
//
// What bounds it on the H100: the sweep is a recurrence along the axis:
// slice s needs slice s -/+ 1 of the 3x3 cells around it. Each cell costs
// 18 candidates x ~53 FP32 operations of the ladder, and 16 B of state read
// and written once: at 256^3, ~0.16 ms of bytes and ~0.5 ms of operations
// (33.5e12/s unfused), so operations bound it, and the dependency chain of
// 256 slices puts a latency floor under it.
//
// What the design does about it: one cooperative launch per directional
// sweep (cudaLaunchCooperativeKernel refuses rather than deadlocks when its
// CTAs cannot all be resident). The plane is cut into kTileR x kTileC
// tiles; a CTA owns tiles blockIdx.x, + gridDim.x, ... for the whole sweep,
// one plane cell per thread, and walks the slices in place with the axis's
// stride (no relayout: a z sweep walks stride-1 columns). Before slice s of
// a tile it waits, through per-tile progress counters in global memory
// (release / acquire at GPU scope), for the 3x3 tiles around it to finish
// slice s -/+ 1, then stages the previous slice's window, (kTileR + 2) x
// (kTileC + 2) cells x 2 slots, as ids and records in shared memory: each
// neighbour's id and record are read once per CTA, not nine times per
// cell. The records are copied by cp.async through L1: neighbouring cells
// often share a nearest triangle, so a window repeats records, and copies
// that bypass L1 (.cg) queue on a few lines of L2 (5.6x slower at 256^3).
// Reads of data other CTAs wrote in this launch go through L2
// (ld.global.cg). A spin that outlasts kSpinCycles traps, so a fault ends
// the launch with an error instead of hanging the card.
//
// Built with -fmad=false so the ladder rounds exactly as the plain version.

#include <cuda_runtime.h>

#include "tri_record.cuh"

namespace {

constexpr int kTileR = 16;                     // plane rows per tile
constexpr int kTileC = 16;                     // plane columns per tile
constexpr int kThreads = kTileR * kTileC;      // one plane cell per thread
constexpr int kWinC = kTileC + 2;              // window columns
constexpr int kWin = (kTileR + 2) * kWinC;     // window cells per slot
constexpr int kMinCtas = 2;                    // CTAs per SM (launch bounds)
constexpr size_t kRecBytes = 2 * kWin * tri::kRecF4 * sizeof(float4);
constexpr long long kSpinCycles = 1LL << 34;   // ~8.7 s at 1.98 GHz

// One directional sweep's geometry: slices n0 (along the sweep axis), plane
// rows n1 and columns n2, their element strides in the x-first volumes, the
// world component of each, and the world coordinate of their first cells
// and their cell sizes.
struct Geom {
  int n0, n1, n2;
  long long s0, s1, s2;
  int comp0, comp1;
  float f0, c0, f1, c1, f2, c2;
  int reverse;
  int tiles1, tiles2;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// 16-byte cp.async through L1 (.ca; tri::cp_async16 bypasses it): the
// window's records repeat, since neighbouring cells often share a nearest
// triangle, and the table is read-only, so most copies hit L1 instead of
// queuing on a few lines of L2.
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
sweep_axis(float* __restrict__ d1, int* __restrict__ i1,
           float* __restrict__ d2, int* __restrict__ i2,
           const float4* __restrict__ rec, int T, Geom g,
           int* __restrict__ progress) {
  extern __shared__ __align__(16) float4 srec[];  // 2 * kWin records
  __shared__ int sid[2 * kWin];
  const int tid = threadIdx.x;
  const int lr = tid / kTileC, lc = tid - (tid / kTileC) * kTileC;
  const int n_tiles = g.tiles1 * g.tiles2;
  for (int k = 0; k < g.n0; ++k) {
    const int s = g.reverse ? g.n0 - 1 - k : k;
    const int prev = g.reverse ? s + 1 : s - 1;
    const float coord_a = g.f0 + static_cast<float>(s) * g.c0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int tr = tile / g.tiles2, tc = tile - (tile / g.tiles2) * g.tiles2;
      const int r0 = tr * kTileR, c0 = tc * kTileC;
      // Thread j < 9 waits for tile (tr + j / 3 - 1, tc + j % 3 - 1) to
      // have finished slice `prev` (its counter is the slices it finished).
      if (k > 0 && tid < 9) {
        const int nr = tr + tid / 3 - 1, nc = tc + tid % 3 - 1;
        if (nr >= 0 && nr < g.tiles1 && nc >= 0 && nc < g.tiles2) {
          const int* flag = progress + nr * g.tiles2 + nc;
          if (ld_acquire(flag) < k) {
            const long long t_start = clock64();
            while (ld_acquire(flag) < k)
              if (clock64() - t_start > kSpinCycles) __trap();
          }
        }
      }
      __syncthreads();  // neighbours ready; all are done with the last window
      for (int w = tid; w < 2 * kWin; w += kThreads) {
        const int slot = w >= kWin;
        const int e = w - slot * kWin;
        const int rr = r0 - 1 + e / kWinC, cc = c0 - 1 + e % kWinC;
        int id = -1;
        if (k > 0 && rr >= 0 && rr < g.n1 && cc >= 0 && cc < g.n2)
          id = __ldcg((slot ? i2 : i1) + prev * g.s0 + rr * g.s1 + cc * g.s2);
        sid[w] = id;
        const float4* src =
            rec + static_cast<long long>(id < 0 ? T : id) * tri::kRecF4;
#pragma unroll
        for (int f = 0; f < tri::kRecF4; ++f)
          cp_async16_ca(srec + w * tri::kRecF4 + f, src + f);
      }
      tri::cp_async_commit();
      tri::cp_async_wait<0>();
      __syncthreads();  // the window has arrived

      const int r = r0 + lr, c = c0 + lc;
      if (r < g.n1 && c < g.n2) {
        // Cell centre: world component comp0 varies along the sweep, comp1
        // along plane rows, the remaining one along plane columns.
        const float coord_r = g.f1 + static_cast<float>(r) * g.c1;
        const float coord_c = g.f2 + static_cast<float>(c) * g.c2;
        const float px =
            g.comp0 == 0 ? coord_a : (g.comp1 == 0 ? coord_r : coord_c);
        const float py =
            g.comp0 == 1 ? coord_a : (g.comp1 == 1 ? coord_r : coord_c);
        const float pz =
            g.comp0 == 2 ? coord_a : (g.comp1 == 2 ? coord_r : coord_c);
        const long long o = s * g.s0 + r * g.s1 + c * g.s2;
        float bd1 = d1[o], bd2 = d2[o];
        int bi1 = i1[o], bi2 = i2[o];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
            for (int slot = 0; slot < 2; ++slot) {
              const int w = slot * kWin + (lr + dy) * kWinC + lc + dz;
              const tri::Record t = tri::load(srec, w);
              const int ci = sid[w];
              const float dc = sqrtf(
                  tri::dist2(t, px - t.r0.x, py - t.r0.y, pz - t.r0.z));
              // _merge2 (pallas_sweep.py:115): slot 2 first, it reads the
              // old slot 1.
              const bool same1 = ci == bi1;
              const bool b1 = dc < bd1;
              if (b1 && !same1) {
                bd2 = bd1;
                bi2 = bi1;
              } else if (!b1 && !same1 && dc < bd2) {
                bd2 = dc;
                bi2 = ci;
              }
              if (b1) {
                bd1 = dc;
                bi1 = ci;
              }
            }
          }
        }
        d1[o] = bd1;
        i1[o] = bi1;
        d2[o] = bd2;
        i2[o] = bi2;
      }
      __syncthreads();  // every cell of the tile is written
      if (tid == 0) {
        __threadfence();
        st_release(progress + tile, k + 1);
      }
    }
  }
}

}  // namespace

// One directional sweep along `axis` (0, 1, 2 = x, y, z; `reverse` from the
// last slice to the first) over the x-first (nx, ny, nz) volumes d1, i1,
// d2, i2, updated in place. rec: T + 1 packed records (the PAD record last,
// for id -1). first/size: world (x, y, z) grid parameters. progress: scratch
// of n_progress int32, at least one per kTileR x kTileC plane tile (sweep.py
// sizes it with its SWEEP_TILE; too few is refused). Zeroes it and makes one
// cooperative launch on `stream`, allocates nothing, returns the first error
// (cudaSuccess = 0).
extern "C" int m2s_sweep_axis(float* d1, int* i1, float* d2, int* i2,
                              const float* rec, int T, int nx, int ny, int nz,
                              int axis, int reverse, float f0, float f1,
                              float f2, float c0, float c1, float c2,
                              int* progress, int n_progress, void* stream) {
  if (axis < 0 || axis > 2 || T < 0) return cudaErrorInvalidValue;
  const int n[3] = {nx, ny, nz};
  const long long stride[3] = {static_cast<long long>(ny) * nz, nz, 1};
  const float first[3] = {f0, f1, f2};
  const float size[3] = {c0, c1, c2};
  // Plane rows and columns: the lower and the higher other axis.
  const int ar = axis == 0 ? 1 : 0, ac = axis == 2 ? 1 : 2;
  Geom g;
  g.n0 = n[axis];
  g.n1 = n[ar];
  g.n2 = n[ac];
  if (g.n0 <= 0 || g.n1 <= 0 || g.n2 <= 0) return cudaSuccess;
  g.s0 = stride[axis];
  g.s1 = stride[ar];
  g.s2 = stride[ac];
  g.comp0 = axis;
  g.comp1 = ar;
  g.f0 = first[axis];
  g.c0 = size[axis];
  g.f1 = first[ar];
  g.c1 = size[ar];
  g.f2 = first[ac];
  g.c2 = size[ac];
  g.reverse = reverse != 0;
  g.tiles1 = (g.n1 + kTileR - 1) / kTileR;
  g.tiles2 = (g.n2 + kTileC - 1) / kTileC;
  const long long n_tiles = static_cast<long long>(g.tiles1) * g.tiles2;
  if (n_tiles > n_progress) return cudaErrorInvalidValue;

  cudaError_t err = cudaFuncSetAttribute(
      sweep_axis, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRecBytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sweep_axis, kThreads, kRecBytes)) != cudaSuccess)
    return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned ctas =
      static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(progress, 0, sizeof(int) * n_tiles, st);
  if (err != cudaSuccess) return err;
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  void* args[] = {&d1, &i1, &d2, &i2, &r4, &T, &g, &progress};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sweep_axis),
                                     dim3(ctas), dim3(kThreads), args,
                                     kRecBytes, st);
}
