// Online-softmax arithmetic shared by the ETAP kernels: the C++ form of
// repro_torch/kernels/softmax_state.py (update / merge_splits), in both
// rescale modes.  Built without -use_fast_math: exp2f, expf and the
// division stay IEEE-accurate.
#pragma once

#include <cuda_runtime.h>

namespace etap {

constexpr float NEG_INF = -1e30f;             // masked logit (never -inf)
constexpr float LOG2E = 1.4426950408889634f;  // log2(e)

// Probability of a (log2-domain for amla) score relative to the running
// stat m: exp2(x) in amla mode, exp(x) in mul mode.
__device__ __forceinline__ float prob_exp(float x, bool amla) {
  return amla ? exp2f(x) : expf(x);
}

// Weight of a stat difference d = m_old - m_new <= 0 (the rescale factor of
// an update, the split weight of a merge).  In amla mode both stats are
// integer-valued floats (or NEG_INF), so 2^d is built from the exponent and
// is exact; d below -200 underflows to 0 like exp2 does.  d == 0 gives 1
// exactly in both modes: a single-split merge is then bitwise the identity.
__device__ __forceinline__ float stat_weight(float d, bool amla) {
  if (d == 0.f) return 1.f;
  if (amla) return ldexpf(1.f, static_cast<int>(fmaxf(d, -200.f)));
  return expf(d);
}

}  // namespace etap
