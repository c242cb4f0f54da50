// The operations of a task's translated hooks (ops/task_kernel.py), with
// torch's semantics on one element: each float product, sum, difference
// and quotient rounds on its own (torch runs them as separate kernels, so
// the card must not contract them into an FMA), clamp, maximum and minimum
// propagate NaN, and integer sums, differences, products and left shifts
// wrap. The generated header includes this file.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TK_HD __host__ __device__ __forceinline__
#else
#define TK_HD inline
#endif

namespace tk {

#ifdef __CUDA_ARCH__
TK_HD float add(float a, float b) { return __fadd_rn(a, b); }
TK_HD float sub(float a, float b) { return __fsub_rn(a, b); }
TK_HD float mul(float a, float b) { return __fmul_rn(a, b); }
TK_HD float div(float a, float b) { return __fdiv_rn(a, b); }
TK_HD float rsqrt(float a) { return rsqrtf(a); }
#else
TK_HD float rsqrt(float a) { return 1.f / sqrtf(a); }
TK_HD float add(float a, float b) { return a + b; }
TK_HD float sub(float a, float b) { return a - b; }
TK_HD float mul(float a, float b) { return a * b; }
TK_HD float div(float a, float b) { return a / b; }
#endif
TK_HD double add(double a, double b) { return a + b; }
TK_HD double sub(double a, double b) { return a - b; }
TK_HD double mul(double a, double b) { return a * b; }
TK_HD double div(double a, double b) { return a / b; }
TK_HD int64_t add(int64_t a, int64_t b) { return (int64_t)((uint64_t)a + (uint64_t)b); }
TK_HD int64_t sub(int64_t a, int64_t b) { return (int64_t)((uint64_t)a - (uint64_t)b); }
TK_HD int64_t mul(int64_t a, int64_t b) { return (int64_t)((uint64_t)a * (uint64_t)b); }
TK_HD int32_t add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
TK_HD int32_t sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
TK_HD int32_t mul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
TK_HD uint32_t add(uint32_t a, uint32_t b) { return a + b; }
TK_HD uint32_t sub(uint32_t a, uint32_t b) { return a - b; }
TK_HD uint32_t mul(uint32_t a, uint32_t b) { return a * b; }

// shifts past the width give 0 (a right shift of a negative value, -1)
TK_HD int64_t shl(int64_t a, int64_t d) { return d < 64 ? (int64_t)((uint64_t)a << d) : 0; }
TK_HD int64_t shr(int64_t a, int64_t d) { return a >> (d < 63 ? d : 63); }
TK_HD int32_t shl(int32_t a, int32_t d) { return d < 32 ? (int32_t)((uint32_t)a << d) : 0; }
TK_HD int32_t shr(int32_t a, int32_t d) { return a >> (d < 31 ? d : 31); }
TK_HD uint32_t shl(uint32_t a, uint32_t d) { return d < 32 ? a << d : 0u; }
TK_HD uint32_t shr(uint32_t a, uint32_t d) { return d < 32 ? a >> d : 0u; }

// torch.remainder: the sign of the divisor
TK_HD int64_t rem(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
TK_HD int32_t rem(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
TK_HD float rem(float a, float b) {
  const float r = fmodf(a, b);
  return (r != 0.f && ((r < 0.f) != (b < 0.f))) ? r + b : r;
}

template <class T>
TK_HD T maximum(T a, T b) { return (a != a) ? a : ((b != b) ? b : (a > b ? a : b)); }
template <class T>
TK_HD T minimum(T a, T b) { return (a != a) ? a : ((b != b) ? b : (a < b ? a : b)); }
template <class T>
TK_HD T clamp(T x, T lo, T hi) {
  if (x != x) return x;
  const T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}
template <class T>
TK_HD T clamp_min(T x, T lo) { return (x != x) ? x : (x < lo ? lo : x); }
template <class T>
TK_HD T clamp_max(T x, T hi) { return (x != x) ? x : (x > hi ? hi : x); }
TK_HD float sign(float x) { return (float)((0.f < x) - (x < 0.f)); }
TK_HD int64_t sign(int64_t x) { return (int64_t)((0 < x) - (x < 0)); }

}  // namespace tk
