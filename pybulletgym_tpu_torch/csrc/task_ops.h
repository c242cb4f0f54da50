// The operations of a task's translated hooks (ops/task_kernel.py), with
// torch's semantics on one element: each float product, sum, difference
// and quotient rounds on its own (torch runs them as separate kernels, so
// the card must not contract them into an FMA), clamp, maximum and minimum
// propagate NaN, and integer sums, differences, products and left shifts
// wrap. The composite ops below (activations, rounding divisions, lerp,
// logaddexp, ...) follow the formula of torch's CUDA kernel for the op,
// each operation rounded on its own as there, and an explicit fma where
// torch writes one (addcmul, addcdiv). The generated header includes this
// file.

#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

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
#ifdef __CUDA_ARCH__
TK_HD double add(double a, double b) { return __dadd_rn(a, b); }
TK_HD double sub(double a, double b) { return __dsub_rn(a, b); }
TK_HD double mul(double a, double b) { return __dmul_rn(a, b); }
TK_HD double div(double a, double b) { return __ddiv_rn(a, b); }
TK_HD double rsqrt(double a) { return ::rsqrt(a); }
#else
TK_HD double add(double a, double b) { return a + b; }
TK_HD double sub(double a, double b) { return a - b; }
TK_HD double mul(double a, double b) { return a * b; }
TK_HD double div(double a, double b) { return a / b; }
TK_HD double rsqrt(double a) { return 1.0 / sqrt(a); }
#endif
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

// -0.0: a zero with its sign bit set (an integer never is). A tie of zeros
// is decided by sign bit, written out, so that g++ and nvcc agree.
template <class T>
TK_HD bool neg_zero(T) { return false; }
TK_HD bool neg_zero(float x) { return x == 0.f && signbit(x); }
TK_HD bool neg_zero(double x) { return x == 0.0 && signbit(x); }

// torch.maximum / minimum (and max / min of two tensors): torch's CUDA
// kernel, NaN first, then ::max / ::min, which order -0.0 below +0.0
// (maximum of a tie of zeros +0.0 unless both are -0.0, minimum -0.0 unless
// both are +0.0)
template <class T>
TK_HD T maximum(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : (a < b ? b : (neg_zero(a) ? b : a))));
}
template <class T>
TK_HD T minimum(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : (a > b ? b : (neg_zero(a) ? a : b))));
}
// The reductions' step (amax, amin, the max of logsumexp, the infinity
// norms): torch's CUDA MaxNanFunctor / MinNanFunctor, (isnan(a) || a > b)
// ? a : b, taken in index order; a tie keeps the later element.
template <class T>
TK_HD T reduce_max(T a, T b) { return (a != a) ? a : ((b != b) ? b : (a > b ? a : b)); }
template <class T>
TK_HD T reduce_min(T a, T b) { return (a != a) ? a : ((b != b) ? b : (a < b ? a : b)); }
// clamp, clamp_min, clamp_max: NaN x first, then ::min(::max(x, lo), hi)
// with the ties of maximum and minimum; a NaN bound leaves x as it was
template <class T>
TK_HD T clamp_min(T x, T lo) {
  return (x != x) ? x : ((x < lo || (x == lo && neg_zero(x))) ? lo : x);
}
template <class T>
TK_HD T clamp_max(T x, T hi) {
  return (x != x) ? x : ((x > hi || (x == hi && neg_zero(hi))) ? hi : x);
}
template <class T>
TK_HD T clamp(T x, T lo, T hi) {
  return (x != x) ? x : clamp_max(clamp_min(x, lo), hi);
}
TK_HD float sign(float x) { return (float)((0.f < x) - (x < 0.f)); }
TK_HD int64_t sign(int64_t x) { return (int64_t)((0 < x) - (x < 0)); }
TK_HD double sign(double x) { return (double)((0.0 < x) - (x < 0.0)); }
TK_HD int32_t sign(int32_t x) { return (int32_t)((0 < x) - (x < 0)); }
TK_HD uint32_t sign(uint32_t x) { return x > 0u ? 1u : 0u; }
TK_HD double rem(double a, double b) {
  const double r = fmod(a, b);
  return (r != 0.0 && ((r < 0.0) != (b < 0.0))) ? r + b : r;
}

// ---- the C math functions by type (float: the f-suffixed one) --------------
#define TK_MATH1(name) \
  TK_HD float name##_(float x) { return name##f(x); } \
  TK_HD double name##_(double x) { return name(x); }
#define TK_MATH2(name) \
  TK_HD float name##_(float x, float y) { return name##f(x, y); } \
  TK_HD double name##_(double x, double y) { return name(x, y); }
TK_MATH1(exp)
TK_MATH1(expm1)
TK_MATH1(log)
TK_MATH1(log1p)
TK_MATH1(tanh)
TK_MATH1(erf)
TK_MATH1(sin)
TK_MATH1(sqrt)
TK_MATH1(floor)
TK_MATH1(trunc)
TK_MATH1(fabs)
TK_MATH1(nearbyint)
TK_MATH2(fmod)
TK_MATH2(copysign)
TK_MATH2(pow)
TK_MATH2(hypot)
TK_MATH2(fmax)
TK_MATH2(fmin)
#undef TK_MATH1
#undef TK_MATH2
TK_HD float fma_(float a, float b, float c) { return fmaf(a, b, c); }
TK_HD double fma_(double a, double b, double c) { return fma(a, b, c); }

template <class T>
TK_HD bool isnan_(T x) { return x != x; }
template <class T>
TK_HD bool isposinf_(T x) { return x == (T)INFINITY; }
template <class T>
TK_HD bool isneginf_(T x) { return x == -(T)INFINITY; }
template <class T>
TK_HD bool isinf_(T x) { return isposinf_(x) || isneginf_(x); }
template <class T>
TK_HD bool isfinite_(T x) { return x == x && !isinf_(x); }

// ---- activations ------------------------------------------------------------
// relu: torch's CUDA clamp_min, NaN or max(x, 0) (so relu(-0) is +0 there)
template <class T>
TK_HD T relu(T x) { return x != x ? x : fmax_(x, T(0)); }
template <class T>
TK_HD T sigmoid(T x) { return div(T(1), add(T(1), exp_(-x))); }
template <class T>
TK_HD T silu(T x) { return div(x, add(T(1), exp_(-x))); }
template <class T>
TK_HD T softplus(T x, T beta, T threshold) {
  const T xb = mul(x, beta);
  return xb > threshold ? x : div(log1p_(exp_(xb)), beta);
}
template <class T>
TK_HD T log_sigmoid(T x) {  // min(0, x) - log1p(exp(-|x|))
  return sub(x < T(0) ? x : T(0), log1p_(exp_(-fabs_(x))));
}
template <class T>
TK_HD T elu(T x, T negcoef, T poscoef, T negiptcoef) {
  return x > T(0) ? mul(x, poscoef) : mul(expm1_(mul(x, negiptcoef)), negcoef);
}
template <class T>
TK_HD T leaky_relu(T x, T slope) { return x > T(0) ? x : mul(x, slope); }
template <class T>
TK_HD T gelu(T x) {  // x / 2 (1 + erf(x / sqrt 2))
  return mul(mul(x, T(0.5)), add(T(1), erf_(mul(x, T(0.70710678118654752440)))));
}
// x / 2 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), the x + 0.044715 x^3 in one
// fma as nvcc contracts torch's CUDA kernel
template <class T>
TK_HD T gelu_tanh(T x) {
  const T beta = T(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  const T inner = mul(beta, fma_(T(0.044715), mul(mul(x, x), x), x));
  return mul(mul(T(0.5), x), add(T(1), tanh_(inner)));
}
template <class T>
TK_HD T mish(T x) { return mul(x, tanh_(log1p_(exp_(x)))); }
template <class T>
TK_HD T logit(T x) { return log_(div(x, sub(T(1), x))); }
template <class T>
TK_HD T logit_eps(T x, T lo, T hi) {
  const T z = x < lo ? lo : (x > hi ? hi : x);
  return log_(div(z, sub(T(1), z)));
}
template <class T>
TK_HD T logaddexp(T a, T b) {
  if (isinf_(a) && a == b) return a;
  return add(fmax_(a, b), log1p_(exp_(-fabs_(sub(a, b)))));
}

// ---- rounding and division ----------------------------------------------------
// div(rounding_mode="floor"), floor_divide: c10::div_floor_floating
template <class T>
TK_HD T div_floor_f(T a, T b, T d, T mod) {
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) d = sub(d, T(1));
  if (d == T(0)) return copysign_(T(0), div(a, b));
  T f = floor_(d);
  return sub(d, f) > T(0.5) ? add(f, T(1)) : f;
}
TK_HD float div_floor(float a, float b) {
  if (b == 0.f) return div(a, b);
  const float mod = fmod_(a, b);
  return div_floor_f(a, b, div(sub(a, mod), b), mod);
}
TK_HD double div_floor(double a, double b) {
  if (b == 0.0) return div(a, b);
  const double mod = fmod_(a, b);
  return div_floor_f(a, b, div(sub(a, mod), b), mod);
}
// by a scalar b with reciprocal inv (torch's CUDA kernel: a product)
template <class T>
TK_HD T div_floor_inv(T a, T b, T inv) {
  const T mod = fmod_(a, b);
  const T d0 = mul(sub(a, mod), inv);
  T d = d0;
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) d = sub(d, T(1));
  if (d == T(0)) return copysign_(T(0), mul(a, inv));
  T f = floor_(d);
  return sub(d, f) > T(0.5) ? add(f, T(1)) : f;
}
// integers (c10::div_floor_integer; a zero divisor gives 0, as there)
template <class T>
TK_HD T div_floor_i(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  if (b == T(0)) return T(0);
  if (std::is_signed<T>::value && b == T(0) - T(1)) return (T)(U(0) - (U)a);
  const T q = a / b;
  return ((a < T(0)) != (b < T(0)) && a % b != T(0)) ? T(q - T(1)) : q;
}
TK_HD int64_t div_floor(int64_t a, int64_t b) { return div_floor_i(a, b); }
TK_HD int32_t div_floor(int32_t a, int32_t b) { return div_floor_i(a, b); }
TK_HD uint32_t div_floor(uint32_t a, uint32_t b) { return div_floor_i(a, b); }
// div(rounding_mode="trunc")
TK_HD float div_trunc(float a, float b) { return trunc_(div(a, b)); }
TK_HD double div_trunc(double a, double b) { return trunc_(div(a, b)); }
template <class T>
TK_HD T div_trunc_i(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  if (b == T(0)) return T(0);
  if (std::is_signed<T>::value && b == T(0) - T(1)) return (T)(U(0) - (U)a);
  return a / b;
}
TK_HD int64_t div_trunc(int64_t a, int64_t b) { return div_trunc_i(a, b); }
TK_HD int32_t div_trunc(int32_t a, int32_t b) { return div_trunc_i(a, b); }
TK_HD uint32_t div_trunc(uint32_t a, uint32_t b) { return div_trunc_i(a, b); }
// fmod of integers (a zero divisor gives 0)
TK_HD int64_t fmod_(int64_t a, int64_t b) { return (b == 0 || b == -1) ? 0 : a % b; }
TK_HD int32_t fmod_(int32_t a, int32_t b) { return (b == 0 || b == -1) ? 0 : a % b; }
TK_HD uint32_t fmod_(uint32_t a, uint32_t b) { return b == 0u ? 0u : a % b; }
// round: half to even; with decimals d, nearbyint(x * 10^d) / 10^d (d < 0:
// nearbyint(x / 10^-d) * 10^-d)
template <class T>
TK_HD T round_(T x) { return nearbyint_(x); }
template <class T>
TK_HD T round_dec(T x, T p, bool negative) {
  return negative ? mul(nearbyint_(div(x, p)), p) : div(nearbyint_(mul(x, p)), p);
}
template <class T>
TK_HD T frac(T x) { return sub(x, trunc_(x)); }

// ---- powers and composites -------------------------------------------------
// integer powers by squaring (at::native::powi), wrapping
template <class T>
TK_HD T powi(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  if (std::is_signed<T>::value && b < T(0)) {
    if (a == T(1)) return T(1);
    if (a == T(0) - T(1)) return (b % T(2)) ? a : T(1);
    return T(0);
  }
  U r = 1u, x = (U)a;
  for (T e = b; e != T(0); e /= T(2)) {
    if (e % T(2)) r *= x;
    x *= x;
  }
  return (T)r;
}
// lerp: a + w (b - a) for |w| < 1/2, else b - (b - a)(1 - w), each with one
// fma, as torch's CPU kernel writes it (vec::fmadd) and nvcc contracts its
// CUDA kernel's
template <class T>
TK_HD T lerp(T a, T b, T w) {
  return fabs_(w) < T(0.5) ? fma_(w, sub(b, a), a) : fma_(sub(w, T(1)), sub(b, a), b);
}
template <class T>
TK_HD T xlogy(T x, T y) {
  if (y != y) return (T)NAN;
  if (x == T(0)) return T(0);
  return mul(x, log_(y));
}
template <class T>
TK_HD T sinc(T x) {
  if (x == T(0)) return T(1);
  const T p = mul(T(3.14159265358979323846), x);
  return div(sin_(p), p);
}
template <class T>
TK_HD T heaviside(T x, T v) { return x == T(0) ? v : (T)(x > T(0)); }
template <class T>
TK_HD T nan_to_num(T x, T nan, T posinf, T neginf) {
  return x != x ? nan : (isposinf_(x) ? posinf : (isneginf_(x) ? neginf : x));
}
// erfinv: the card's erfinvf (torch's CUDA kernel); on the host (the CPU
// tests' twin) the formula of torch's CPU kernel (ATen/native/Math.h ·
// calc_erfinv: a rational first guess, two Newton steps), in double
template <class T>
TK_HD T erfinv_host(T y) {
  const T ya = fabs_(y);
  if (ya > T(1)) return (T)NAN;
  if (ya == T(1)) return copysign_((T)INFINITY, y);
  T x;
  if (ya <= T(0.7)) {
    const T z = mul(y, y);
    const T num = add(mul(add(mul(add(mul(T(-0.140543331), z), T(0.914624893)), z),
                                  T(-1.645349621)), z), T(0.886226899));
    const T dem = add(mul(add(mul(add(mul(add(mul(T(0.012229801), z), T(-0.329097515)), z),
                                          T(1.442710462)), z), T(-2.118377725)), z), T(1));
    x = div(mul(y, num), dem);
  } else {
    const T z = sqrt_(-log_(div(sub(T(1), ya), T(2))));
    const T num = add(mul(add(mul(add(mul(T(1.641345311), z), T(3.429567803)), z),
                              T(-1.624906493)), z), T(-1.970840454));
    const T dem = add(mul(add(mul(T(1.637067800), z), T(3.543889200)), z), T(1));
    x = div(copysign_(num, y), dem);
  }
  const T k = mul(T(2), T(0.564189583547756286948));  // 2 / sqrt(pi)
  for (int i = 0; i < 2; ++i) x = sub(x, div(sub(erf_(x), y), mul(k, exp_(mul(-x, x)))));
  return x;
}
#ifdef __CUDA_ARCH__
TK_HD float erfinv(float y) { return erfinvf(y); }
TK_HD double erfinv(double y) { return ::erfinv(y); }
#else
TK_HD float erfinv(float y) { return (float)erfinv_host((double)y); }
TK_HD double erfinv(double y) { return erfinv_host(y); }
#endif

}  // namespace tk
