// The IEEE quotient with a zero dividend kept off the division's slow path,
// shared by kkt.cu (cho_solve) and disc.cu.
//
// The correctly rounded division (div.rn.f32, div.rn.f64) runs a short
// reciprocal-and-refine sequence and branches to a checked slow path for
// any operand the short sequence cannot take; an exact zero dividend is one
// of them (on the H100, tridiag_factor's division phases ran twice as long
// on inputs with a quarter exact zeros). Where the dividend is +-0 and the
// divisor a nonzero number or an infinity, the quotient is the signed zero
// s * copysign(1, d): the same bits as s / d. Every other pair (a nonzero,
// infinite or NaN dividend; a zero or NaN divisor) takes the division. So
// div_zs(s, d) equals s / d bit for bit for every s and d. The form
// s * (1 / d) would not: 1 / d overflows to infinity at the smallest
// subnormal d, and 0 * inf is NaN where 0 / d is +-0.

#pragma once

#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ T div_zs(T s, T d) {
  // a branch, not a select: the division must not run for a zero dividend
  if (s == T(0) && fabs(d) > T(0)) return s * copysign(T(1), d);
  return s / d;
}
