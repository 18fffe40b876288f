// The magnitude-shrink factor every kernel's threshold applies
// (pseudo_3d_interpolation_tpu/ops/pallas/pocs_iter.py::_shrink): hard keeps
// |c| >= tau, tested as |c|² >= tau²; soft shrinks the magnitude by tau; the
// non-negative garrote scales by (1 - tau²/|c|²)+.
#pragma once

#include <math.h>

enum ThreshOp { OP_HARD = 0, OP_SOFT = 1, OP_GARROTE = 2 };

__device__ __forceinline__ float shrink_factor(float mag2, float tau, int op) {
  if (op == OP_SOFT) {
    float mag = sqrtf(mag2);
    float denom = mag == 0.0f ? 1.0f : mag;
    return fmaxf(1.0f - tau / denom, 0.0f);
  }
  if (op == OP_GARROTE) {
    float denom = mag2 == 0.0f ? 1.0f : mag2;
    return fmaxf(1.0f - (tau * tau) / denom, 0.0f);
  }
  return mag2 >= tau * tau ? 1.0f : 0.0f;
}

// |c|² of c = (x, y) with x·x and y·y each rounded before the sum, never
// fused into a multiply-add: as the plain versions' re·re + im·im rounds
// it. The percentile route computes its keys, sqrt of this, and tests
// |c|² >= tau² on it, so the coefficient that sets tau is judged alike on
// both sides.
__device__ __forceinline__ float abs2_rn(float2 c) {
  return __fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y));
}
