// Moller-Trumbore of one ray against one (p0, e1, e2) triangle row, shared
// by csrc/wide_bvh.cu (the wide walk's leaves) and csrc/sweep_bvh.cu (the
// cull-sweep's groups), so that a mesh's hits do not depend on the route its
// triangle count sends it to. Every product and sum is rounded alone
// (__fmul_rn / __fsub_rn / __fadd_rn, an IEEE division, no contraction) in
// ops/wide_bvh.py::mt_test's order, which the plain walk and the plain
// sweep both call: the kernels and their plain versions agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// row(k) returns the row's value k of 9 (p0.xyz, e1.xyz, e2.xyz), so each
// caller keeps its own loads (a global read, or registers filled ahead).
// The ray is (o, d) in the row's space; sets the world t = t * scl and
// returns the accept rule: u, v >= 0, (1 - u) - v >= 0, t > tmin (row
// space) and t_w < cap (world). 1 / det is 0 where |det| <= 1e-12, so a
// zero or degenerate row gives t = 0 and never passes a tmin >= 0.
template <typename Row>
__device__ __forceinline__ bool mt_test(Row row, float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float tmin, float cap, float scl,
                                        float& t_w) {
  const float e2x = row(6), e2y = row(7), e2z = row(8);
  const float px = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
  const float py = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
  const float pz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
  const float e1x = row(3), e1y = row(4), e1z = row(5);
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, px), __fmul_rn(e1y, py)),
                              __fmul_rn(e1z, pz));
  const float inv_det = fabsf(det) > 1e-12f ? __fdiv_rn(1.0f, det) : 0.0f;
  const float tx = __fsub_rn(ox, row(0));
  const float ty = __fsub_rn(oy, row(1));
  const float tz = __fsub_rn(oz, row(2));
  const float uu = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)),
                __fmul_rn(tz, pz)), inv_det);
  const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
  const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
  const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
  const float vv = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, qx), __fmul_rn(dy, qy)),
                __fmul_rn(dz, qz)), inv_det);
  const float tt = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)),
                __fmul_rn(e2z, qz)), inv_det);
  t_w = __fmul_rn(tt, scl);
  return uu >= 0.0f && vv >= 0.0f &&
         __fsub_rn(__fsub_rn(1.0f, uu), vv) >= 0.0f && tt > tmin && t_w < cap;
}
