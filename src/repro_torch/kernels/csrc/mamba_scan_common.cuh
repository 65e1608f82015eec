// What the selective scan's forward (mamba_scan.cu) and backward (mamba_scan_bwd.cu) must
// agree on: the spacing of the states that the forward's training form saves and the
// backward recomputes the old states from, and the decay exp(delta A), which both form as
// ex2.approx.ftz(delta * A log2 e), so that the backward recomputes the old states by the
// forward's own operations.  Each source is still its own library; this header is compiled
// into both, and the build's digest covers it.

#pragma once

namespace {

constexpr int CK = 16;  // tokens between the saved states: one tile of the backward
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit; exp(delta A) = ex2(delta * (A LOG2E)), A LOG2E formed once.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
