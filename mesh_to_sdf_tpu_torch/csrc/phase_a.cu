// CULLED phase A for Hopper (sm_90a): per sub-tile centre, the nearest
// blocks by the coarse box bound, ranked by the fine csphere bound.
//
// Replaces the JAX package's `_phase_a_hier` and the tail of
// `_phase_a_topk` (mesh_to_sdf_tpu/ops/kernels/pallas_culled.py:195, :308),
// XLA glue on the TPU with no Pallas kernel behind it. The Python wrapper
// and the plain PyTorch version (_phase_a_hier_plain, the eager chunked
// computation this kernel is held bit-equal to) live in
// mesh_to_sdf_tpu_torch/ops/kernels/culled.py. Phase A's flat branch
// (_phase_a_flat_lb, B <= 2 c) stays eager: no cell runs it.
//
// What it computes, per sub-tile centre c (one CTA each):
// 1. Coarse window: the box distance to every block AABB,
//    sqrt(gx*gx + gy*gy + gz*gz) with g = max(max(lo - c, c - hi), 0); the
//    cc + 1 smallest, cc = min(c_win, B - 1), ordered by (value, block id),
//    as the plain version's stable sort gives them. The first cc are the
//    window, the (cc + 1)-th value is lb_rest.
// 2. Fine bounds: for each window block, the minimum over its tb triangles
//    of max(sqrt(|c - cen|^2) - r, 0), from the packed csphere table
//    (B * tb float4 [cx, cy, cz, r], BlockIndex.csphere).
// 3. Ranking: the window sorted by (fine bound, position in the window),
//    the plain version's stable argsort.
// Full mode (kg = 0) writes the plain version's triple: lb_c (n_sub, cc)
// ascending, the block ids in that order, lb_rest. Top-k mode (kg > 0,
// the gather engine's _phase_a_topk) writes only the first kg ids and
// lb_excl = minimum(lb_c[kg], lb_rest).
//
// What bounds it on the H100: the fine level, n_sub * cc * tb pairs of
// ~12 FP32 operations and a correctly rounded root, each pair reading 16 B
// of the csphere table from L2 (1.3 MB at B = 320). At the
// query_82k_raycast.uniform cell's main pass (15 680 sub-tiles, cc 96, tb
// 256) that is 3.9e8 pairs, ~0.14 ms of FP32 issue at half of 67 TFLOP/s
// (-fmad=false), and ~6 GB of L2 reads, ~1 ms: L2 bandwidth bounds it.
// The coarse level is n_sub * B box distances, ~1 % of that.
//
// What the design does about it: one CTA of 256 threads per sub-tile, no
// intermediate in device memory. The coarse distances go to shared memory
// as their float bits (4 B a block: non-negative floats order as their
// bits), and the cc + 1 smallest keys (bits << 32 | block id; unique, so
// ties resolve by id) are found by a radix select over 8-bit digits (at
// most 6 passes, a 256-bin histogram each, stopping as soon as the chosen
// bucket holds exactly the remaining rank), then sorted by a bitonic sort
// of the next power of two. Each warp reduces one window block's tb
// triangles (a coalesced 512 B float4 row per step) with a warp min; min
// is exact in any order, so the bound is the plain version's bit for bit.
// The window's (bound bits << 32 | position) keys are then sorted the same
// way. Shared memory: 4 B a block plus two sorting buffers, dynamic above
// 48 KB (B up to ~53 000 blocks at c 96).
//
// Every multiply, add and root is written as its correctly rounded
// intrinsic, so the sums round as the plain version's whatever the flags.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;  // 8-bit radix digits
static_assert(kBins == kThreads, "one histogram bin per thread");
// Largest cc + 1: the width of the selection sort.
constexpr int kMaxWindow = 1024;
// Block ids fill the low 16 bits of a key.
constexpr int kMaxBlocks = 1 << 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ int key_low(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

// Inclusive sum over the CTA of one value per thread.
__device__ __forceinline__ int cta_inclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sums[w];
  __syncthreads();
  return v;
}

// Ascending bitonic sort of n keys (a power of two) in shared memory,
// written before the call and visible to every thread.
__device__ void bitonic_sort(unsigned long long* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = s[i], b = s[p];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
phase_a_hier(const float* __restrict__ centers, const float* __restrict__ lo,
             const float* __restrict__ hi, int n_blocks,
             const float4* __restrict__ csph, int tb, int cc, int win_n,
             int rank_n, int kg, float* __restrict__ out_lb,
             int* __restrict__ out_idx, float* __restrict__ out_bound) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* win = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* rank = win + win_n;
  int* hist = reinterpret_cast<int*>(rank + rank_n);
  unsigned* dist = reinterpret_cast<unsigned*>(hist + kBins);
  __shared__ int warp_sums[kWarps];
  __shared__ int s_digit, s_rank, s_count, s_fill;

  const long long s = blockIdx.x;
  const int tid = threadIdx.x;
  const float cx = __ldg(centers + 3 * s);
  const float cy = __ldg(centers + 3 * s + 1);
  const float cz = __ldg(centers + 3 * s + 2);

  // 1. Coarse: the box distance to every block, as its float bits.
  for (int b = tid; b < n_blocks; b += kThreads) {
    const float* l = lo + 3 * b;
    const float* h = hi + 3 * b;
    const float gx = fmaxf(fmaxf(__fsub_rn(__ldg(l), cx),
                                 __fsub_rn(cx, __ldg(h))), 0.0f);
    const float gy = fmaxf(fmaxf(__fsub_rn(__ldg(l + 1), cy),
                                 __fsub_rn(cy, __ldg(h + 1))), 0.0f);
    const float gz = fmaxf(fmaxf(__fsub_rn(__ldg(l + 2), cz),
                                 __fsub_rn(cz, __ldg(h + 2))), 0.0f);
    dist[b] = __float_as_uint(__fsqrt_rn(sq3(gx, gy, gz)));
  }

  // Radix select of the cc + 1 smallest keys (bits << 32 | id): the
  // distance's four bytes, then the id's one or two. `prefix` holds the
  // digits fixed so far under `mask`; r is the rank still wanted among the
  // keys that match them.
  const int id_bytes = n_blocks > 256 ? 2 : 1;
  unsigned long long prefix = 0, mask = 0;
  int r = cc + 1;
  for (int pass = 0; pass < 4 + id_bytes; ++pass) {
    const int shift = pass < 4 ? 56 - 8 * pass : 8 * (3 + id_bytes - pass);
    hist[tid] = 0;
    __syncthreads();
    for (int b = tid; b < n_blocks; b += kThreads) {
      const unsigned long long key =
          static_cast<unsigned long long>(dist[b]) << 32 | b;
      if ((key & mask) == prefix)
        atomicAdd(&hist[static_cast<int>(key >> shift) & 0xff], 1);
    }
    __syncthreads();
    const int count = hist[tid];
    const int incl = cta_inclusive_sum(count, warp_sums);
    if (incl - count < r && r <= incl) {
      s_digit = tid;
      s_rank = r - (incl - count);
      s_count = count;
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    mask |= 0xffull << shift;
    r = s_rank;
    // Every key of the chosen bucket is wanted (keys are unique, so this
    // holds at the last digit at the latest).
    if (s_count == r) break;
  }

  // The wanted keys are those whose fixed digits are at most the prefix.
  if (tid == 0) s_fill = 0;
  __syncthreads();
  for (int b = tid; b < n_blocks; b += kThreads) {
    const unsigned long long key =
        static_cast<unsigned long long>(dist[b]) << 32 | b;
    if ((key & mask) <= prefix) win[atomicAdd(&s_fill, 1)] = key;
  }
  for (int i = cc + 1 + tid; i < win_n; i += kThreads) win[i] = kPadKey;
  __syncthreads();
  bitonic_sort(win, win_n);

  // 2. Fine: one warp per window block, the min over its triangles.
  const int lane = tid & 31, warp = tid >> 5;
  for (int w = warp; w < cc; w += kWarps) {
    const float4* t = csph + static_cast<long long>(key_low(win[w])) * tb;
    float m = __int_as_float(0x7f800000);
    for (int j = lane; j < tb; j += 32) {
      const float4 v = __ldg(t + j);
      const float d = __fsub_rn(
          __fsqrt_rn(sq3(__fsub_rn(cx, v.x), __fsub_rn(cy, v.y),
                         __fsub_rn(cz, v.z))),
          v.w);
      m = fminf(m, fmaxf(d, 0.0f));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0)
      rank[w] = static_cast<unsigned long long>(__float_as_uint(m)) << 32 | w;
  }
  for (int i = cc + tid; i < rank_n; i += kThreads) rank[i] = kPadKey;
  __syncthreads();

  // 3. Ranking by (fine bound, window position).
  bitonic_sort(rank, rank_n);
  const float rest = key_value(win[cc]);
  if (kg > 0) {
    for (int i = tid; i < kg; i += kThreads)
      out_idx[s * kg + i] = key_low(win[key_low(rank[i])]);
    if (tid == 0) {
      const float a = key_value(rank[kg]);
      out_bound[s] = (a != a || a < rest) ? a : rest;  // torch.minimum
    }
  } else {
    for (int i = tid; i < cc; i += kThreads) {
      out_lb[s * cc + i] = key_value(rank[i]);
      out_idx[s * cc + i] = key_low(win[key_low(rank[i])]);
    }
    if (tid == 0) out_bound[s] = rest;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory of one CTA for n_blocks blocks and window c (0 when
// the arguments are out of range); culled.phase_a_smem_bytes mirrors it.
long long smem_bytes(int n_blocks, int c) {
  if (n_blocks < 2 || n_blocks > kMaxBlocks || c < 1) return 0;
  const int cc = c < n_blocks - 1 ? c : n_blocks - 1;
  if (cc + 1 > kMaxWindow) return 0;
  return 8LL * (pow2_at_least(cc + 1) + pow2_at_least(cc)) + 4LL * kBins +
         4LL * n_blocks;
}

}  // namespace

// Phase A of n_sub sub-tile centres (n_sub, 3) against n_blocks blocks:
// AABBs lo, hi (n_blocks, 3), csphere table (n_blocks * tb, 4), window
// c_win. kg = 0: lb (n_sub, cc) ascending, idx (n_sub, cc) block ids,
// bound (n_sub,) = lb_rest. kg > 0 (kg < cc): idx (n_sub, kg), bound =
// lb_excl, lb unused. One launch on `stream`, allocates nothing, returns
// the first error (cudaSuccess = 0).
extern "C" int m2s_phase_a_hier(const float* centers, int n_sub,
                                const float* lo, const float* hi,
                                int n_blocks, const float* csphere, int tb,
                                int c_win, int kg, float* lb, int* idx,
                                float* bound, void* stream) {
  const long long bytes = smem_bytes(n_blocks, c_win);
  if (n_sub < 0 || bytes == 0 || tb <= 0 || tb % 32 != 0 || kg < 0)
    return cudaErrorInvalidValue;
  const int cc = c_win < n_blocks - 1 ? c_win : n_blocks - 1;
  if (kg >= cc) return cudaErrorInvalidValue;
  if (n_sub == 0) return cudaSuccess;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_a_hier, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  phase_a_hier<<<static_cast<unsigned>(n_sub), kThreads,
                 static_cast<size_t>(bytes), st>>>(
      centers, lo, hi, n_blocks, reinterpret_cast<const float4*>(csphere), tb,
      cc, pow2_at_least(cc + 1), pow2_at_least(cc), kg, lb, idx, bound);
  return cudaGetLastError();
}
