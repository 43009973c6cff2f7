// The Mercer and random Fourier epilogues of the port's Gram kernels:
// Epilogue, the reference's kernel_matrix._epilogue for a kind chosen at
// run time (mercer<KIND> folds the choice into an instantiation), and
// RffEpilogue, the random Fourier feature map of embed_assign.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// RFF is no Mercer kind: it selects RffEpilogue (embed_assign.cu only)
enum Kind { LINEAR = 0, POLYNOMIAL = 1, COSINE = 2, RBF = 3, RFF = 4 };

struct Epilogue {
  int kind;
  float gamma;
  float coef0;
  int degree;

  // The reference's kernel_matrix._epilogue, term for term: rbf clamps the
  // squared distance at 0, cosine clamps the norm product at 1e-12.
  __device__ __forceinline__ float operator()(float acc, float xs,
                                              float ys) const {
    switch (kind) {
      case POLYNOMIAL: {
        float base = gamma * acc + coef0;
        float r = 1.0f;
        for (int i = 0; i < degree; ++i) r *= base;
        return r;
      }
      case COSINE: {
        float den = sqrtf(fmaxf(xs, 0.0f)) * sqrtf(fmaxf(ys, 0.0f));
        return acc / fmaxf(den, 1e-12f);
      }
      case RBF: {
        float d2 = fmaxf(xs + ys - 2.0f * acc, 0.0f);
        return expf(-gamma * d2);
      }
      default:
        return acc;
    }
  }
};

// The reduced cosine's range: its Cody-Waite reduction is exact for |x| <
// 105615.
constexpr float COS_REDUCED_MAX = 105615.0f;

// cos x for |x| <= COS_REDUCED_MAX, to about an ulp of f32 (7e-8 at worst
// in an f32 emulation, as the library's cosf): x = q pi/2 + r by
// Cody-Waite reduction in three FMAs, then Cephes's minimax polynomials
// for cos r or sin r on |r| <= pi/4, signed by the quadrant. No branch.
__device__ __forceinline__ float cos_reduced(float x) {
  const float q = rintf(x * 0.636619772f);             // 2 / pi
  float r = fmaf(q, -1.57079601e+00f, x);              // pi/2 in 3 parts
  r = fmaf(q, -3.13916473e-07f, r);
  r = fmaf(q, -5.39030253e-15f, r);
  const int i = (int)q;
  const float r2 = r * r;
  const bool odd = i & 1;   // sin r, else cos r
  float z = odd ? -1.9515295891e-4f : 2.443315711809948e-5f;
  z = fmaf(z, r2, odd ? 8.3321608736e-3f : -1.388731625493765e-3f);
  z = fmaf(z, r2, odd ? -1.6666654611e-1f : 4.166664568298827e-2f);
  z = fmaf(z, r2, odd ? 0.0f : -0.5f);
  const float v = odd ? fmaf(z, r, r) : fmaf(z, r2, 1.0f);
  // quadrant i mod 4: cos r, -sin r, -cos r, sin r
  return ((i + 1) & 2) ? -v : v;
}

// past the reduced range (and for NaN) the library's cosf, out of line
static __device__ __noinline__ float cos_large(float x) { return cosf(x); }

// The random Fourier feature map, scale * cos(x.w + b): ys carries the
// column's phase b (the slot of |y|^2 for the Mercer kinds), xs is unused.
// A type of its own, so the Mercer kernels compile no cosine. Full range,
// never __cosf: |x.w + b| grows with gamma and |x|, and __cosf loses its
// accuracy past a few multiples of pi. Two forms of one value, each the
// faster in its body (launch/kernel_ab.py on an H100, at Fig.5's 60,000 x
// 784 -> 320): the library's cosf for the f32 body, where the outlined
// form cost 2%; outlined(), cos_reduced with cosf's Payne-Hanek path out
// of line, for the bf16 body, where cosf inlined that path at each of a
// tile's 64 accumulators and took 0.243 ms of the card a call, not 0.205.
struct RffEpilogue {
  float scale;   // sqrt(2/m)

  __device__ __forceinline__ float operator()(float acc, float,
                                              float ys) const {
    return scale * cosf(acc + ys);
  }
  __device__ __forceinline__ float outlined(float acc, float ys) const {
    const float x = acc + ys;
    return scale *
           (fabsf(x) <= COS_REDUCED_MAX ? cos_reduced(x) : cos_large(x));
  }
};

// The Mercer epilogue of kind KIND: the switch of Epilogue folds away, so
// that the accumulators of a body instantiated per kind meet one formula.
template <int KIND>
__device__ __forceinline__ float mercer(Epilogue e, float acc, float xs,
                                        float ys) {
  e.kind = KIND;
  return e(acc, xs, ys);
}

}  // namespace rt
