// Packed per-triangle records for Hopper (sm_90a), shared by the fused
// raycast and normal kernels (csrc/sdf.cu), the block-culled kernel
// (csrc/culled.cu) and the CPT sweep (csrc/sweep.cu).
//
// A record holds everything a (query, triangle) pair reads that depends on
// the triangle alone, computed once (by sdf.cu's m2s_tri_records) with the
// arithmetic of the TPU kernels' per-triangle terms
// (mesh_to_sdf_tpu/ops/kernels/pallas_sdf.py:57-140): the vertex a, the
// edges ab = b - a and ac = c - a, A = |ab|^2, B = ab.ac, C = |ac|^2, the
// four safe reciprocals 1/A, 1/C, 1/(A - 2B + C), 1/(AC - B^2) (0 where the
// denominator is 0), the edge ac - ab of the crossing test
// (pallas_sdf.py:143-178) or, in a normal record, the normal ab x ac, and
// the degenerate-triangle flags. Five float4 =
// 80 bytes, 16-byte aligned, so a pair loop reads a triangle from shared
// memory with five 128-bit broadcast loads, and staging is a copy with no
// arithmetic (cp.async, 16 bytes a thread). The plain PyTorch version of the
// packing is sdf.tri_records_plain (fields in sdf.RECORD_FIELDS order).
//
// Everything here rounds as written: the kernels are built with
// -fmad=false, and 1/x is the correctly rounded quotient.

#pragma once

#include <cuda_runtime.h>

namespace tri {

constexpr int kRecF4 = 5;  // float4 per record
constexpr float kF32Max = 3.402823466e+38f;

// Degenerate-triangle flags (pallas_sdf.py:121-133), as int bits in r4.w.
constexpr int kSegAb = 1;  // b == c or c == a: segment [a, b]
constexpr int kEqAb = 2;   // b == a: segment [a, c]
constexpr int kAllEq = 4;  // a == b == c: vertex a

struct Record {
  float4 r0;  // ax, ay, az, A
  float4 r1;  // abx, aby, abz, B
  float4 r2;  // acx, acy, acz, C
  float4 r3;  // 1/A, 1/C, 1/(A - 2B + C), 1/(AC - B^2), 0 where x == 0
  float4 r4;  // (ac - ab).xyz, or the normal ab x ac; flags (int bits)
};

__device__ __forceinline__ float rcp0(float x) {
  return x == 0.0f ? 0.0f : __fdiv_rn(1.0f, x);
}

// jnp.clip(x, 0, 1).
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// With `normal`, r4.xyz holds the normal n = ab x ac (the normal-sign
// kernel's; pallas_sdf.py:241) in place of ac - ab.
__device__ __forceinline__ Record pack(float ax, float ay, float az,
                                       float abx, float aby, float abz,
                                       float acx, float acy, float acz,
                                       bool normal) {
  const float A = abx * abx + aby * aby + abz * abz;
  const float B = abx * acx + aby * acy + abz * acz;
  const float C = acx * acx + acy * acy + acz * acz;
  const bool eq_ab = abx == 0.0f && aby == 0.0f && abz == 0.0f;
  const bool eq_ac = acx == 0.0f && acy == 0.0f && acz == 0.0f;
  const bool eq_bc = abx == acx && aby == acy && abz == acz;
  const int flags = ((eq_bc || eq_ac) ? kSegAb : 0) | (eq_ab ? kEqAb : 0) |
                    ((eq_ab && eq_bc) ? kAllEq : 0);
  Record t;
  t.r0 = make_float4(ax, ay, az, A);
  t.r1 = make_float4(abx, aby, abz, B);
  t.r2 = make_float4(acx, acy, acz, C);
  t.r3 = make_float4(rcp0(A), rcp0(C), rcp0(A - 2.0f * B + C),
                     rcp0(A * C - B * B));
  if (normal) {
    t.r4 = make_float4(aby * acz - abz * acy, abz * acx - abx * acz,
                       abx * acy - aby * acx, __int_as_float(flags));
  } else {
    t.r4 = make_float4(acx - abx, acy - aby, acz - abz,
                       __int_as_float(flags));
  }
  return t;
}

// Record m of a staged array (five 128-bit shared-memory loads).
__device__ __forceinline__ Record load(const float4* s, int m) {
  const float4* p = s + kRecF4 * m;
  return Record{p[0], p[1], p[2], p[3], p[4]};
}

// Squared distance from the query (ap = q - a) to the triangle:
// closest_point_vw + dist2 of pallas_sdf.py, same override order. The
// degenerate overrides come last, so they sit behind one test of the flags,
// which is the same for every lane of a warp (all read one triangle).
__device__ __forceinline__ float dist2(const Record& t, float apx, float apy,
                                       float apz) {
  const float abx = t.r1.x, aby = t.r1.y, abz = t.r1.z;
  const float acx = t.r2.x, acy = t.r2.y, acz = t.r2.z;
  const float A = t.r0.w, B = t.r1.w, C = t.r2.w;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float d3 = d1 - A;
  const float d4 = d2 - B;
  const float d5 = d1 - B;
  const float d6 = d2 - C;
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;
  const float t_ab = d1 * t.r3.x;
  const float t_ac = d2 * t.r3.y;
  const float t_bc = (d4 - d3) * t.r3.z;
  const float inv_den = t.r3.w;

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
  const int flags = __float_as_int(t.r4.w);
  if (flags != 0) {
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
  }
  const float ap2 = apx * apx + apy * apy + apz * apz;
  const float dd = ap2 + v * (v * A - 2.0f * d1 + 2.0f * w * B) +
                   w * (w * C - 2.0f * d2);
  return dd < 0.0f ? 0.0f : dd;  // jnp.maximum(dd, 0)
}

// --------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace tri
