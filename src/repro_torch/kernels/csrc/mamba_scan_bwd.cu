// Mamba-1 selective scan backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// No Pallas kernel computes it: the reference differentiates the scan with JAX (jax.grad
// through `ssm_chunked_scan`, src/repro/models/mamba.py, whose function the Pallas kernel
// `mamba_scan_pallas` in src/repro/kernels/mamba_scan.py computes forward).  Per batch row,
// channel d and state n, with a_t = exp(delta_t A) and g_t the whole gradient reaching the
// state h_t, swept from g_S = C_S dy_S + dh_fin (or C_S dy_S) down to dh0 = a_1 g_1:
//
//     g_t-1 = C_t-1 dy_t-1 + a_t g_t
//     du_t  = delta_t sum_n B_t g_t          ddelta_t = sum_n g_t (A a_t h_t-1 + u_t B_t)
//     dA    = sum_b,t g_t delta_t a_t h_t-1   dB_t = sum_d g_t delta_t u_t      dC_t = sum_d h_t dy_t
//
// Old states.  h_t-1 cannot be had from h_t by dividing by a_t: large delta |A| brings the
// decay close to 0.  The forward's training form (csrc/mamba_scan.cu) saves the state
// before every CK = 16 tokens (mamba_scan_common.cuh).  For each span of CK tokens, the
// last first, this kernel recomputes the span's CK old states forward from the saved one
// into registers and then sweeps the span's tokens backwards.
//
// Design.  A block holds CB = 64 channels of one batch row; each thread one channel and
// NS = 4 of its states (L = ds / 4 neighbouring lanes share a channel), the layout of the
// forward, so the saved states, h0's gradient and dA load and store as one 16-byte chunk
// a lane.  Tiles of CK tokens of u, delta, dy (the block's channels) and B, C are staged
// with cp.async, last span first, double buffered (28 KB at ds = 16), and zero-filled past
// the sequence and past di: there delta = 0 makes a token an identity (decay 1, drive 0,
// no gradient but the carry), so the loop runs in whole spans and only the stores look at
// the ends.  The tokens go in groups of UB = 8:
// - du and ddelta are sums over a channel's states: a group's 2 UB partials (B.g and
//   A a h_t-1.g per token) meet in one reduce-scatter across the channel's L lanes, as the
//   forward's y partials do, after which each lane holds both sums of 2 UB / L / 2 tokens
//   and stores du_t = delta_t B.g and ddelta_t = A a h.g + u_t B.g;
// - dB and dC are sums over all di channels: a group's 2 UB NS partials a thread meet in a
//   reduce-scatter across the warp's channels (the lanes that differ above the channel's
//   own), each warp's sums go to shared memory, and the block adds its warps in a fixed
//   order and writes one partial per block of channels, [B, di / CB, S, ds] each, which
//   the wrapper adds with one torch.sum;
// - dA sums over the batch and the tokens: each thread accumulates its own states over the
//   tokens and writes one partial per batch row, [B, di, ds], added by the wrapper.
// No atomics: two calls give the same bits.
//
// Decays.  Both sweeps form exp(delta A) as the forward does, ex2.approx(delta A log2 e)
// (mamba_scan_common.cuh), so it recomputes the old states by the forward's own operations.  The
// carry g runs over the whole sequence, and at jamba's slowest channels (delta near 1e-3,
// A = -1) it remembers about a thousand tokens, so each exponential's rounding adds up:
// the gradients are held against exact ones (mamba_scan_bwd_plain in f64), not against the
// f32 plain version, whose own rounding is of the same size.  At f32 B4 S2048 di8192 ds16
// on an H100 (scripts/scan_bwd_precision.py), ddelta and dh0, the gradients furthest from
// exact, came within 1.2e-4 and 7.1e-5 of their rms, where the accurate expf gave 2.8e-4
// and 1.3e-4 and the f32 plain version (expf too) the same; du, dA, dB and dC came a little
// further than with expf (at most 5.8e-5 against 2.4e-5); 2.12 ms a call against 2.33 ms
// with expf in the same call.
//
// Bound.  Per token, channel and state: recomputing the state (delta A, the exponential,
// (delta u) B, the state's multiply-add: 4 FLOP and one exp) and the gradient (g's
// multiply-add, B.g's, g a, g a h, A's and delta's multiply-adds into ddelta and dA,
// g delta u, h_t dy, the carry a g, the adds of dB and dC across channels: 17 FLOP), 21 FLOP
// and one exp, if the decays of the recompute were kept (this kernel forms each decay twice,
// to keep its registers to the states).  At f32 B4 S2048 di8192 ds16: 22.5 GFLOP, 0.337 ms at
// 67 TFLOP/s; the 1.07 G exponentials 0.256 ms on the special-function units; the bytes
// (u, delta, dy and the saved states read, du and ddelta written: 1.61 GB; B, C, A, dA, dB,
// dC small) 0.482 ms.  So 0.482 ms, bound by the bytes.
//
// Inputs, all float32, contiguous and 16-byte aligned: u, delta, dy [B, S, di]; A [di, ds];
// B, C [B, S, ds]; h_chk [B, ceil(S / CK), di, ds]; dh_fin [B, di, ds] (optional).  Outputs,
// float32: du, ddelta [B, S, di]; dA_part [B, di, ds]; dB_part, dC_part [B, ceil(di / CB), S,
// ds]; dh0 [B, di, ds].  ds in {4, 8, 16}; any di (rows that are not whole 16-byte chunks
// are staged 4 bytes at a time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_common.cuh"  // CK, LOG2E, ex2

namespace {

constexpr int NS = 4;    // states per thread: one 16-byte chunk
constexpr int CB = 64;   // channels per block
constexpr int UB = 8;    // tokens per group: one reduce-scatter of each kind

template <int DS>
struct Geometry {
  static constexpr int L = DS / NS;                 // lanes that share a channel
  static constexpr int LG = 32 / L;                 // channels of a warp
  static constexpr int NW = CB / LG;                // warps of a block
  static constexpr int NT = 32 * NW;
  static constexpr int KEEP = 2 * UB / L;           // (token, du | ddelta) sums a lane holds after its channel's reduction
  static constexpr int NBC = 2 * UB * NS;           // a thread's dB and dC partials of a group
  static constexpr int KEEPC = NBC / LG;            // of which it holds after its warp's reduction
  static constexpr int UD = CK * CB, BC = CK * DS;  // floats of u (delta, dy) and of B (C) in a tile
  static constexpr int STAGE = 3 * UD + 2 * BC;
  static constexpr int RED = NW * UB * 2 * DS;      // each warp's dB and dC sums of a group
  static constexpr int SMEM = (2 * STAGE + RED) * 4;
  static_assert(L >= 1 && L <= UB && KEEP % 2 == 0 && NBC % LG == 0 && CK % UB == 0, "groups");
  static_assert(CK * CB % NT == 0 && (CK * CB / 4) % NT == 0, "staging");
  static_assert(SMEM <= 48 * 1024, "within the default dynamic shared memory, no opt-in");
};

__device__ __forceinline__ void load4(const float* p, float (&o)[NS]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[NS]) {
  *reinterpret_cast<float4*>(p) = float4{o[0], o[1], o[2], o[3]};
}

// global -> shared, asynchronously; zero-filled (nothing read) when !in.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Halving steps of a reduce-scatter across the lanes that differ in bits D, D / 2, ..., STOP:
// p[0 .. 2M) in; at each step the lane keeps one half (the upper one if lane & D) summed
// with its partner's.  After the last step p[0 .. NI / (2 D / STOP)) holds the sums of items
// (lane / STOP % (2 D / STOP)) * that count + i.
template <int D, int STOP, int M, int NI>
__device__ __forceinline__ void reduce_scatter(float (&p)[NI], int lane) {
  if constexpr (D >= STOP && D >= 1) {
    const bool up = lane & D;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = up ? p[i] : p[i + M];
      const float keep = up ? p[i + M] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, D);
    }
    reduce_scatter<D / 2, STOP, M / 2>(p, lane);
  }
}

template <int DS>
__global__ void __launch_bounds__(Geometry<DS>::NT, 1) mamba_scan_bwd_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ h_chk,
    const float* __restrict__ dy, const float* __restrict__ dh_fin, float* __restrict__ du,
    float* __restrict__ ddelta, float* __restrict__ dA_part, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dh0, int seq, int di) {
  using Gm = Geometry<DS>;
  constexpr int L = Gm::L, LG = Gm::LG, NT = Gm::NT, KEEP = Gm::KEEP, KEEPC = Gm::KEEPC;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + 2 * Gm::STAGE;  // [NW][UB][2][DS]: each warp's dB (0) and dC (1) sums of a group

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sg = lane % L;                 // states sg * 4 .. sg * 4 + 3 of ...
  const int cl = warp * LG + lane / L;     // ... channel ch0 + cl
  const int blk = blockIdx.x, b = blockIdx.y, ch0 = blk * CB, ch = ch0 + cl;
  const bool live = ch < di;
  const int nchunk = (seq + CK - 1) / CK, nblk = gridDim.x;
  const size_t row0 = (size_t)b * seq;     // token rows of this batch row
  const bool whole_chunks = di % 4 == 0;

  float av[NS], a2[NS], carry[NS], dA[NS];  // A, A log2 e, a_t+1 g_t+1 (dh_fin past the end), dA
  const bool has_dhfin = dh_fin != nullptr;
  if (live) {
    load4(A + (size_t)ch * DS + sg * NS, av);
    if (has_dhfin) load4(dh_fin + ((size_t)b * di + ch) * DS + sg * NS, carry);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!live) av[s] = 0.f;
    a2[s] = av[s] * LOG2E;
    if (!(live && has_dhfin)) carry[s] = 0.f;
    dA[s] = 0.f;
  }

  auto stage = [&](int q) {  // tile q holds span nchunk - 1 - q; one cp.async group, empty past the end
    if (q < nchunk) {
      float* us = smem + q % 2 * Gm::STAGE;
      float* dts = us + Gm::UD;
      float* dys = dts + Gm::UD;
      float* bs = dys + Gm::UD;
      float* cs = bs + Gm::BC;
      const int t0 = (nchunk - 1 - q) * CK;
      if (whole_chunks) {
        constexpr int CH = CB / 4;
#pragma unroll
        for (int i = 0; i < CK * CH / NT; ++i) {
          const int e = tid + i * NT, t = e / CH, qd = e % CH * 4;
          const bool in = t0 + t < seq && ch0 + qd < di;
          const size_t g = in ? (row0 + t0 + t) * di + ch0 + qd : 0;
          cp_async16(us + t * CB + qd, u + g, in);
          cp_async16(dts + t * CB + qd, delta + g, in);
          cp_async16(dys + t * CB + qd, dy + g, in);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < CK * CB / NT; ++i) {
          const int e = tid + i * NT, t = e / CB, qd = e % CB;
          const bool in = t0 + t < seq && ch0 + qd < di;
          const size_t g = in ? (row0 + t0 + t) * di + ch0 + qd : 0;
          cp_async4(us + t * CB + qd, u + g, in);
          cp_async4(dts + t * CB + qd, delta + g, in);
          cp_async4(dys + t * CB + qd, dy + g, in);
        }
      }
      constexpr int BCH = CK * DS / 4;  // B and C: CK rows of DS floats, BCH 16-byte chunks each
#pragma unroll
      for (int i = 0; i < (BCH + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, t = e / (DS / 4), qd = e % (DS / 4) * 4;
        const bool in = t0 + t < seq;
        const size_t g = in ? (row0 + t0 + t) * DS + qd : 0;
        if (e < BCH) {
          cp_async16(bs + t * DS + qd, Bm + g, in);
          cp_async16(cs + t * DS + qd, Cm + g, in);
        }
      }
    }
    cp_async_commit();
  };

  stage(0);
  for (int q = 0; q < nchunk; ++q) {
    const int c = nchunk - 1 - q, t0 = c * CK, n = min(CK, seq - t0);
    cp_async_wait_all();
    __syncthreads();  // this tile has landed, and every thread is done with the previous one
    stage(q + 1);     // into the buffer the previous tile used
    const float* us = smem + q % 2 * Gm::STAGE;
    const float* dts = us + Gm::UD;
    const float* dys = dts + Gm::UD;
    const float* bs = dys + Gm::UD;
    const float* cs = bs + Gm::BC;

    // The span's old states h_t-1, t = t0 .. t0 + CK - 1, recomputed from the saved one.
    float hs[CK][NS];
    {
      float h[NS];
      if (live) {
        load4(h_chk + (((size_t)b * nchunk + c) * di + ch) * DS + sg * NS, h);
      } else {
#pragma unroll
        for (int s = 0; s < NS; ++s) h[s] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < CK; ++i) {
        float bq[NS];
        load4(bs + i * DS + sg * NS, bq);
        const float dt = dts[i * CB + cl], x = dt * us[i * CB + cl];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          hs[i][s] = h[s];
          h[s] = fmaf(ex2(dt * a2[s]), h[s], x * bq[s]);
        }
      }
    }

    // The span's tokens backwards, a group of UB at a time, the last group first.
#pragma unroll
    for (int gi = CK / UB - 1; gi >= 0; --gi) {
      float p[2 * UB];   // item 2 k + 0: B.g, 2 k + 1: A a h_t-1 . g, of token gi UB + k
      float pbc[Gm::NBC];  // item (2 k + 0 | 1) NS + s: g delta u | h_t dy of state s, token gi UB + k
#pragma unroll
      for (int k = UB - 1; k >= 0; --k) {
        const int i = gi * UB + k;
        float bq[NS], cq[NS];
        load4(bs + i * DS + sg * NS, bq);
        load4(cs + i * DS + sg * NS, cq);
        const float dt = dts[i * CB + cl], x = dt * us[i * CB + cl], dyt = dys[i * CB + cl];
        float pu = 0.f, pa = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float a = ex2(dt * a2[s]);
          const float g = fmaf(cq[s], dyt, carry[s]);
          const float ga = g * a;
          const float gah = ga * hs[i][s];
          pu = fmaf(g, bq[s], pu);
          pa = fmaf(gah, av[s], pa);
          dA[s] = fmaf(gah, dt, dA[s]);
          pbc[(2 * k) * NS + s] = g * x;
          pbc[(2 * k + 1) * NS + s] = fmaf(a, hs[i][s], x * bq[s]) * dyt;
          carry[s] = ga;
        }
        p[2 * k] = pu;
        p[2 * k + 1] = pa;
      }

      // du and ddelta: the sums over the channel's states, KEEP / 2 tokens a lane.
      reduce_scatter<L / 2, 1, UB>(p, lane);
#pragma unroll
      for (int j = 0; j < KEEP / 2; ++j) {
        const int i = gi * UB + KEEP / 2 * sg + j;
        if (live && i < n) {
          const size_t o = (row0 + t0 + i) * di + ch;
          du[o] = dts[i * CB + cl] * p[2 * j];
          ddelta[o] = fmaf(us[i * CB + cl], p[2 * j], p[2 * j + 1]);
        }
      }

      // dB and dC: the sums over the warp's channels, then over the warps in a fixed order.
      reduce_scatter<16, L, Gm::NBC / 2>(pbc, lane);
#pragma unroll
      for (int j = 0; j < KEEPC; ++j) {
        const int item = lane / L * KEEPC + j, k = item / (2 * NS), which = item / NS % 2, s = item % NS;
        red[((warp * UB + k) * 2 + which) * DS + sg * NS + s] = pbc[j];
      }
      __syncthreads();
      for (int e = tid; e < UB * 2 * DS; e += NT) {
        const int k = e / (2 * DS), which = e / DS % 2, nn = e % DS, i = gi * UB + k;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < Gm::NW; ++w) acc += red[((w * UB + k) * 2 + which) * DS + nn];
        if (i < n) (which ? dC_part : dB_part)[(((size_t)b * nblk + blk) * seq + t0 + i) * DS + nn] = acc;
      }
      __syncthreads();  // red is free again
    }
  }

  if (live) {
    store4(dh0 + ((size_t)b * di + ch) * DS + sg * NS, carry);
    store4(dA_part + ((size_t)b * di + ch) * DS + sg * NS, dA);
  }
}

template <int DS>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bm, const float* Cm,
                   const float* h_chk, const float* dy, const float* dh_fin, float* du, float* ddelta,
                   float* dA_part, float* dB_part, float* dC_part, float* dh0, int batch, int seq, int di,
                   cudaStream_t stream) {
  using Gm = Geometry<DS>;
  const dim3 grid((di + CB - 1) / CB, batch);
  mamba_scan_bwd_kernel<DS><<<grid, Gm::NT, Gm::SMEM, stream>>>(u, delta, A, Bm, Cm, h_chk, dy, dh_fin, du,
                                                                 ddelta, dA_part, dB_part, dC_part, dh0, seq, di);
  return cudaGetLastError();
}

}  // namespace

// ds must be 4, 8 or 16; dh_fin may be null (zero).  Returns a cudaError_t (0 = launched).
extern "C" int mamba_scan_backward(const void* u, const void* delta, const void* A, const void* Bm, const void* Cm,
                                   const void* h_chk, const void* dy, const void* dh_fin, void* du, void* ddelta,
                                   void* dA_part, void* dB_part, void* dC_part, void* dh0, int batch, int S, int di,
                                   int ds, void* stream) {
  if (batch <= 0 || S <= 0 || di <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* df = static_cast<const float*>(delta);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* kf = static_cast<const float*>(h_chk);
  const float* yf = static_cast<const float*>(dy);
  const float* ff = static_cast<const float*>(dh_fin);
  float* o0 = static_cast<float*>(du);
  float* o1 = static_cast<float*>(ddelta);
  float* o2 = static_cast<float*>(dA_part);
  float* o3 = static_cast<float*>(dB_part);
  float* o4 = static_cast<float*>(dC_part);
  float* o5 = static_cast<float*>(dh0);
  switch (ds) {
    case 4: return (int)launch<4>(uf, df, af, bf, cf, kf, yf, ff, o0, o1, o2, o3, o4, o5, batch, S, di, st);
    case 8: return (int)launch<8>(uf, df, af, bf, cf, kf, yf, ff, o0, o1, o2, o3, o4, o5, batch, S, di, st);
    case 16: return (int)launch<16>(uf, df, af, bf, cf, kf, yf, ff, o0, o1, o2, o3, o4, o5, batch, S, di, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mamba_scan_bwd_block_channels() { return CB; }

extern "C" const char* mamba_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
