// Fused flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body `_attn_kernel`)
// in src/repro/kernels/flash_attention.py.  Same function: online-softmax
// attention with f32 running max / sum / accumulator, GQA (query head h reads
// KV head h / (H / Kv)), causal and sliding-window masks on absolute positions
// shifted by q_offset, the Gemma2 logit softcap applied before the mask, and
// tiles that no query of the block can see skipped.
//
// Layout.  One thread block per (q tile of BQ = 64 rows, head, batch row).
// The TPU kernel walks KV tiles as the innermost *grid* axis and carries
// m / l / acc in VMEM scratch between grid steps; blocks on a GPU run in no
// order, so here the KV walk is a loop inside the block and the running state
// stays in registers.  The loop starts at the first KV tile any query of the
// block may see and stops after the last one, so dead causal and window tiles
// cost nothing.  q [B,S,H,hd] and k, v [B,T,Kv,hd] are read in place (no
// head-major copy); ragged S and T are masked here, so the caller pads nothing.
//
// Work split.  8 warps, each owning 8 query rows.  For scores, lane c of a
// warp owns key column c of the 32-key tile: the 8 scores of a lane are
// reduced across lanes with shuffles for the row max and row sum, so the
// softmax needs no shared memory.  For P·V, lane c owns head-dim columns
// c, c+32, ...; the probabilities are broadcast from their lane by shuffle.
//
// Bound.  At the main path's long prompt (H=8, Kv=4, hd=256, S=T=4608 or
// 8192) the work is ~4·H·S·keys·hd FLOP against ~4·S·H·hd bytes of I/O: far
// above the H100's ridge point, so it is bound by operations.  This first
// version does the products with scalar f32 FMAs on the CUDA cores (peak
// ~67 TFLOP/s, not the tensor cores' 989), with the tiles in shared memory:
// Q is read from shared memory as a warp-wide broadcast and K through a
// padded row stride so that float4 reads do not collide in banks.  Moving the
// products to wgmma with TMA-fed tiles is the next step (ROADMAP.md).
//
// Masked scores are filled with the reference's finite -1e30, not -inf: a row
// whose first live tile is fully masked then gets exp(0) weights that the
// first real key rescales away (corr = exp(-1e30 - m) = 0), where -inf would
// give exp(-inf + inf) = NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per tile: one per lane
constexpr int NWARPS = 8;
constexpr int ROWS = BQ / NWARPS;      // query rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_HD = 256;
constexpr float BIG_NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.x & 0xffffu))),
                     __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.x >> 16))),
                     __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.y & 0xffffu))),
                     __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.y >> 16))));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Copy `rows` rows of hd elements (global row stride `stride` elements) into
// shared memory as f32 with row stride `ld`; rows at or past `valid` are zero.
// hd % 4 == 0, so every row is read and written four elements at a time.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t stride,
                                          int rows, int valid, int hd) {
  const int hd4 = hd >> 2;
  for (int idx = threadIdx.x; idx < rows * hd4; idx += NTHREADS) {
    const int r = idx / hd4;
    const int d = (idx - r * hd4) << 2;
    const float4 x = r < valid ? load4(src + r * stride + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + d) = x;
  }
}

// NJ = head-dim columns per lane in P·V: 1 for hd <= 32, 8 for hd <= 256.  Only
// those two run (the smoke geometry and gemma2); a head dim in between takes NJ = 8
// with its upper lanes idle until a configuration needs its own instantiation.
template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int S, int T_len, int H, int Kv, int hd, int causal,
              int window, float cap, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = hd + 4;                // padded K rows: lane c reads row c conflict-free
  float* Qs = smem;                      // [BQ][hd]
  float* Ks = Qs + BQ * hd;              // [BK][hd + 4]
  float* Vs = Ks + BK * ldk;             // [BK][hd]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q_rows = min(BQ, S - q0);

  const int64_t q_stride = (int64_t)H * hd;    // elements between consecutive positions
  const int64_t kv_stride = (int64_t)Kv * hd;
  const T* qb = q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd;
  const T* kb = k + (int64_t)b * T_len * kv_stride + (int64_t)kvh * hd;
  const T* vb = v + (int64_t)b * T_len * kv_stride + (int64_t)kvh * hd;
  T* ob = o + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd;

  load_tile(Qs, hd, qb, q_stride, BQ, q_rows, hd);

  // keys any query of this block may see: [k_lo, k_hi)
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + q0 + q_rows - 1;
  const int k_lo = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int k_hi = causal ? min(T_len, qp_hi + 1) : T_len;
  const int kt_begin = k_lo / BK;
  const int kt_end = k_hi > k_lo ? (k_hi + BK - 1) / BK : kt_begin;

  float m[ROWS], l[ROWS], acc[ROWS][NJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const float* qr = Qs + warp * ROWS * hd;
  const float* kr = Ks + lane * ldk;
  const int qp0 = qp_lo + warp * ROWS;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and Q is loaded, first time round)
    load_tile(Ks, ldk, kb + k0 * kv_stride, kv_stride, BK, min(BK, T_len - k0), hd);
    load_tile(Vs, hd, vb + k0 * kv_stride, kv_stride, BK, min(BK, T_len - k0), hd);
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + i * hd + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // scale, softcap, mask, online softmax (row reductions across the warp)
    const int kj = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = qp0 + i;
      float x = s[i] * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      bool ok = kj < T_len;
      if (causal) ok = ok && kj <= qp;
      if (window > 0) ok = ok && kj > qp - window;
      x = ok ? x : BIG_NEG;
      const float m_new = fmaxf(m[i], warp_max(x));
      p[i] = expf(x - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }

    // acc += P · V; lane owns head-dim columns lane + 32 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < hd ? Vs[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pc = __shfl_sync(FULL, p[i], c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store(ob + r * q_stride + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int H, int Kv, int hd, int causal, int window, float cap, int q_offset,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * hd + (size_t)BK * (hd + 4) + (size_t)BK * hd);
  auto kern = fa_fwd_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), S, T_len,
                                         H, Kv, hd, causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                     int H, int Kv, int hd, int causal, int window, float cap, int q_offset,
                     float scale, cudaStream_t stream) {
  if (hd <= 32) return launch<T, 1>(q, k, v, o, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
  return launch<T, 8>(q, k, v, o, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int B, int S,
                          int T_len, int H, int Kv, int hd, int causal, int window, float softcap,
                          int q_offset, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || hd <= 0 ||
      hd > MAX_HD || hd % 4 != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, S, T_len, H, Kv, hd, causal, window, softcap, q_offset, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, Kv, hd, causal, window, softcap, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
