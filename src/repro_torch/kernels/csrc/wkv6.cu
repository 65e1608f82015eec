// RWKV-6 WKV recurrence for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (body `_wkv_kernel`) in
// src/repro/kernels/rwkv6_scan.py, and computes the function of its jnp twin
// `wkv_chunked` (src/repro/models/rwkv6.py), which the reference's prefill and
// decode run because they carry a state: per head, with an f32 C x C state S,
//
//     out_t,j = sum_i r_t,i (S_ij + u_i k_t,i v_t,j)
//     S_ij   <- w_t,i S_ij + k_t,i v_t,j
//
// starting from s0 (or zero) and returning the final state.  The Pallas
// kernel's zero-state, no-state-out form is the special case s0 = 0.
//
// Form.  The TPU kernel works chunk by chunk with matrix products whose
// exponents are kept non-positive; this first Hopper version runs the
// recurrence token by token instead, which needs no exponentials at all and
// cannot overflow at the full model's decays.  Column j of S evolves on its
// own (its update reads w_i, k_i and v_j only), so columns are split across
// blocks and threads freely: one block per (group of JB = 32 columns, head,
// batch row) with NSPLIT = 4 warps.  Warp q owns rows i = q + NSPLIT m of the
// block's columns, one column per lane, in registers.  Every lane of a warp
// reads the same (r_i, k_i, w_i) float4 from shared memory, a single
// broadcast; each lane keeps four independent partial sums of its column's
// output (so the adds do not form one long chain), and the warps' partials
// meet in shared memory, summed once per tile of TT = 16 tokens.  The next
// tile is loaded into registers, as stored (bf16 or f32), while the current
// one is computed, so the loads' latency hides behind the arithmetic.
//
// Bound.  Per token and head the recurrence does about 5 C^2 f32 operations
// against r, k, v (2 or 4 bytes each), w and out (4 bytes) of C channels: at
// C = 64 that is 16 (f32) to 23 (bf16) operations per byte, about the ridge
// of the f32 CUDA cores (67 TFLOP/s over 3.35 TB/s = 20), so bytes and
// operations bound it about equally (chip_smoke.py computes both).  This
// version issues about 5 instructions per state element and token, on one
// block of 4 warps per SM at B = 1, H = 64: one warp per scheduler, so
// latency the warp cannot hide still costs time; the chunked tensor-core form
// is the next step (ROADMAP.md).
//
// Inputs: r, k, v [B, S, H, C] in f32 or bf16; w [B, S, H, C], u [H, C] and
// s0 [B, H, C, C] (optional) in f32.  Outputs, both f32: out [B, S, H, C] and
// s_fin [B, H, C, C].  All contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSPLIT = 4;  // row groups of a column, one per warp at C >= 32
constexpr int TT = 16;     // tokens staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int C>
struct Shape {
  static constexpr int JB = C < 32 ? C : 32;  // state columns per block
  static constexpr int R = C / NSPLIT;        // state rows per thread
  static constexpr int NT = JB * NSPLIT;      // threads per block
  static constexpr int PER = TT * C / NT;     // r, k, w elements each thread stages per tile
  static constexpr int PERV = TT / NSPLIT;    // v elements (the block's columns only)
  static constexpr int NACC = R < 4 ? R : 4;  // independent partial sums of an output
  static_assert(PER * NT == TT * C && PERV * NT == TT * JB, "threads must tile the staged tokens");
};

template <typename T, int C>
__global__ void __launch_bounds__(Shape<C>::NT) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ s_fin, int seq, int H) {
  constexpr int JB = Shape<C>::JB, R = Shape<C>::R, NT = Shape<C>::NT;
  constexpr int PER = Shape<C>::PER, PERV = Shape<C>::PERV, NACC = Shape<C>::NACC;
  __shared__ float4 rkw[TT][C];          // (r_i, k_i, w_i, unused) of each staged token
  __shared__ float vs[TT][JB];           // v of the block's columns
  __shared__ float part[NSPLIT][TT][JB];  // each row group's share of every output

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int jl = tid % JB, col0 = blockIdx.x * JB;
  const int j = col0 + jl;  // the state column this thread owns ...
  const int q = tid / JB;   // ... at rows i = q + NSPLIT * m
  const size_t state_base = ((size_t)b * H + h) * C * C;

  float st[R], uu[R];
  const bool has_s0 = s0 != nullptr;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = q + NSPLIT * m;
    st[m] = has_s0 ? s0[state_base + (size_t)i * C + j] : 0.f;
    uu[m] = u[h * C + i];
  }

  // The next tile, as stored: r, k, w element e = tid + p NT is token e / C,
  // channel e % C; v element e = tid + p NT is token e / JB, column col0 + e % JB.
  T nr[PER], nk[PER], nv[PERV];
  float nw[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT, tt = e / C;
      if (t0 + tt < seq) {
        const size_t g = (((size_t)b * seq + t0 + tt) * H + h) * C + e % C;
        nr[p] = r[g];
        nk[p] = k[g];
        nw[p] = w[g];
      }
    }
#pragma unroll
    for (int p = 0; p < PERV; ++p) {
      const int e = tid + p * NT, tt = e / JB;
      if (t0 + tt < seq) nv[p] = v[(((size_t)b * seq + t0 + tt) * H + h) * C + col0 + e % JB];
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < seq; t0 += TT) {
    const int n = min(TT, seq - t0);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      if (e / C < n) rkw[e / C][e % C] = make_float4(to_f32(nr[p]), to_f32(nk[p]), nw[p], 0.f);
    }
#pragma unroll
    for (int p = 0; p < PERV; ++p) {
      const int e = tid + p * NT;
      if (e / JB < n) vs[e / JB][e % JB] = to_f32(nv[p]);
    }
    __syncthreads();
    if (t0 + TT < seq) fetch(t0 + TT);  // in flight while this tile is computed
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][jl];
      float acc[NACC] = {};
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float4 p = rkw[tt][q + NSPLIT * m];
        const float kv = p.y * vj;
        acc[m % NACC] = fmaf(p.x, fmaf(uu[m], kv, st[m]), acc[m % NACC]);  // r_i (S_ij + u_i k_i v_j)
        st[m] = fmaf(p.z, st[m], kv);                                       // w_i S_ij + k_i v_j
      }
      float o = acc[0];
#pragma unroll
      for (int a = 1; a < NACC; ++a) o += acc[a];
      part[q][tt][jl] = o;
    }
    __syncthreads();
    for (int e = tid; e < n * JB; e += NT) {
      const int tt = e / JB, c = e % JB;
      float o = part[0][tt][c];
#pragma unroll
      for (int g = 1; g < NSPLIT; ++g) o += part[g][tt][c];
      out[(((size_t)b * seq + t0 + tt) * H + h) * C + col0 + c] = o;
    }
  }

#pragma unroll
  for (int m = 0; m < R; ++m) s_fin[state_base + (size_t)(q + NSPLIT * m) * C + j] = st[m];
}

template <typename T, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, float* out, float* s_fin, int B, int seq, int H,
                   cudaStream_t stream) {
  const dim3 grid(C / Shape<C>::JB, H, B);
  wkv6_kernel<T, C><<<grid, Shape<C>::NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      out, s_fin, seq, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, float* out, float* s_fin, int B, int seq, int H, int C,
                     cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(r, k, v, w, u, s0, out, s_fin, B, seq, H, stream);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_fin, B, seq, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_fin, B, seq, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_fin, B, seq, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16.  s0 may be null (zero state).
// Returns a cudaError_t (0 = launched).
extern "C" int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, void* out, void* s_fin, int B, int S,
                            int H, int C, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* of = static_cast<float*>(out);
  float* ff = static_cast<float*>(s_fin);
  if (dtype == 0) return (int)dispatch<float>(r, k, v, wf, uf, sf, of, ff, B, S, H, C, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(r, k, v, wf, uf, sf, of, ff, B, S, H, C, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
