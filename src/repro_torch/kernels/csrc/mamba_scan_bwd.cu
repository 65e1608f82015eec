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
// Design (redesigned for Hopper).  A block holds CB = 64 channels of one batch row; each thread one
// channel and NS = 4 of its states (L = ds / 4 neighbouring lanes share a channel), the layout of
// the forward, so the saved states, h0's gradient and dA load and store as one 16-byte chunk a
// lane.  256 threads at most 128 registers and 56 KB of shared memory (at ds 16; opted into once
// per instantiation, csrc/opt_in.cuh) make two blocks an SM, 16 warps to hide each other's
// latency.  Per span of CK tokens, the last first:
// - staging: u, delta, dy (the block's channels), B and C, and the span's saved state come in by
//   cp.async with the tile, double buffered, zero-filled past the sequence and past di: there
//   delta = 0 makes a token an identity (decay 1, drive 0, no gradient but the carry), so the
//   loop runs in whole spans and only the stores look at the ends;
// - recompute: the span's CK old states into registers (hs, 64 of them), then the sweep over its
//   tokens backwards, forming each decay again (keeping them needs 64 more registers, and keeping
//   half a span's at a time costs a third recompute pass);
// - du and ddelta are sums over a channel's states: UD = 4 tokens' B.g and A a h_t-1.g meet in one
//   reduce-scatter across the channel's L lanes, after which each lane stores both sums of
//   2 UD / L / 2 tokens: du_t = delta_t B.g, ddelta_t = A a h.g + u_t B.g;
// - dB and dC are sums over all di channels.  A token's 2 NS items a thread halve across the
//   warp's channels in three steps (lane bits 16, 8, 4), one item a lane left, which goes to
//   shared memory for the whole span.  The first step needs no select: lanes 16 apart keep their
//   states in swapped slots (B and C are staged a second time with each chunk's halves swapped,
//   and A, the saved state, dh_fin, dA and dh0 swap in registers).  After the span's sweep (a
//   second barrier) the block adds each output's 8 warps in a fixed order and writes one partial
//   per block of channels, [B, di / CB, S, ds] each, which the wrapper adds with one torch.sum;
// - dA sums over the batch and the tokens: each thread accumulates its own states over the
//   tokens and writes one partial per batch row, [B, di, ds], added by the wrapper.
// No atomics: two calls give the same bits.
//
// Cost, and what lost.  The ds-16 instantiation's span body is ~1,580 instructions a thread for
// 64 state-tokens (~25 each; ~29 with the span's staging and sums).  At f32 B4 S2048 di8192 ds16
// on an H100 80GB HBM3 at 700 W a call takes 1.46 ms (the kernel 1.39-1.40); a one-block,
// 229-register layout of the same algebra, five barriers a span and the saved state loaded in
// front of the recompute, took 2.12.  Without the dB / dC steps the call takes 0.33 ms less,
// without du / ddelta's 0.17, without the recompute 0.22, without the sweep's exponentials 0.03
// (scripts/scan_variants.py's scan_bwd_no_* probes).  Slower there (its scan_bwd_* variants): one block
// an SM (1.84 ms), 128 channels a block (1.45, and spills), the saved state loaded instead of staged
// (0.01-0.06 ms slower in every call).  Slower too, and not kept (PERF.md): kept decays over half
// spans (1.52), dB / dC in one or two steps leaving 32 or 16 items an output to shared memory (1.55,
// 1.48), the other two steps freed of selects by staging B and C in four orders, du / ddelta summed
// in shared memory or two tokens at a time, the warps' dB / dC sums moved beside the next span's
// recompute, two channels of 2 states a thread (1.48-1.62: half the dB / dC items, but du / ddelta
// summed over 8 lanes), and clusters of 2 or 8 blocks adding dB / dC in distributed shared memory
// (1.59-1.94: fewer blocks resident, and each waits for its cluster every span).
//
// Decays.  The recompute and the sweep form exp(delta A) as the forward does,
// ex2.approx(delta A log2 e) (mamba_scan_common.cuh), so the old states are recomputed by the
// forward's own operations and the sweep's decay is bitwise the recompute's.  The carry g runs
// over the whole sequence, and at jamba's slowest channels (delta near 1e-3, A = -1) it
// remembers about a thousand tokens, so each exponential's rounding adds up: the gradients are
// held against exact ones (mamba_scan_bwd_plain in f64), not against the f32 plain version, whose
// own rounding is of the same size (scripts/scan_bwd_precision.py gives each gradient's distance).
//
// Bound.  Per token, channel and state: recomputing the state (delta A, the exponential,
// (delta u) B, the state's multiply-add: 4 FLOP and one exp) and the gradient (g's
// multiply-add, B.g's, g a, g a h, A's and delta's multiply-adds into ddelta and dA,
// g delta u, h_t dy, the carry a g, the adds of dB and dC across channels: 17 FLOP), 21 FLOP
// and one exp, if the decays of the recompute were kept.  At f32 B4 S2048 di8192 ds16:
// 22.5 GFLOP, 0.337 ms at 67 TFLOP/s; the 1.07 G exponentials 0.256 ms on the special-function
// units; the bytes (u, delta, dy and the saved states read, du and ddelta written: 1.61 GB; B,
// C, A, dA, dB, dC small) 0.482 ms.  So 0.482 ms, bound by the bytes.
//
// Inputs, all float32, contiguous and 16-byte aligned: u, delta, dy [B, S, di]; A [di, ds];
// B, C [B, S, ds]; h_chk [B, ceil(S / CK), di, ds]; dh_fin [B, di, ds] (optional).  Outputs,
// float32: du, ddelta [B, S, di]; dA_part [B, di, ds]; dB_part, dC_part [B, ceil(di / CB), S,
// ds]; dh0 [B, di, ds].  ds in {4, 8, 16}; any di (rows that are not whole 16-byte chunks
// are staged 4 bytes at a time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_common.cuh"  // CK, LOG2E, ex2
#include "opt_in.cuh"             // opt_in_once, MAX_DEVICES

namespace {

constexpr int NS = 4;               // states per thread: one 16-byte chunk
constexpr int CB = 64;              // channels per block
constexpr int UD = 4;               // tokens of one du / ddelta reduce-scatter
constexpr int MIN_BLOCKS = 2;       // blocks an SM: at most 128 registers a thread
constexpr float LN2 = 0.6931471805599453f;

template <int DS>
struct Geometry {
  static constexpr int L = DS / NS;                 // lanes that share a channel
  static constexpr int LG = 32 / L;                 // channels of a warp
  static constexpr int NW = CB / LG;                // warps of a block
  static constexpr int NT = 32 * NW;
  static constexpr int KEEP = 2 * UD / L;           // (token, du | ddelta) sums a lane holds after its channel's reduction
  static constexpr int R = 4 / L;                   // lanes of a warp that hold the same dB / dC item after its 3 steps
  static constexpr int TILE = CK * CB, BC = CK * DS, HS = CB * DS;  // floats of u (delta, dy), B (C), the saved state
  static constexpr int STAGE = 3 * TILE + 4 * BC + HS;  // B and C in two state orders each
  static constexpr int RED = NW * CK * 32;          // each lane's dB / dC item of a span's tokens
  static constexpr int SMEM = (2 * STAGE + RED) * 4;
  static_assert(L >= 1 && L <= 4 && KEEP % 2 == 0 && CK % UD == 0, "groups");
  static_assert(NT * NS == HS && CK * CB % NT == 0 && (CK * CB / 4) % NT == 0, "staging");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 227 * 1024, "shared memory for MIN_BLOCKS blocks an SM");
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
__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(in ? 8 : 0));
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

// A thread's state slot s holds state s ^ 2 of its four when `swap` (lanes 16 .. 31): the halves of o swapped.
__device__ __forceinline__ void swap_halves(float (&o)[NS], bool swap) {
#pragma unroll
  for (int s = 0; s < NS / 2; ++s) {
    const float lo = o[s], hi = o[s + NS / 2];
    o[s] = swap ? hi : lo;
    o[s + NS / 2] = swap ? lo : hi;
  }
}

template <int DS>
__global__ void __launch_bounds__(Geometry<DS>::NT, MIN_BLOCKS) mamba_scan_bwd_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ h_chk,
    const float* __restrict__ dy, const float* __restrict__ dh_fin, float* __restrict__ du,
    float* __restrict__ ddelta, float* __restrict__ dA_part, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dh0, int seq, int di) {
  using Gm = Geometry<DS>;
  constexpr int L = Gm::L, NT = Gm::NT, KEEP = Gm::KEEP;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + 2 * Gm::STAGE;  // [NW][CK][32]: each lane's dB / dC item of the span's tokens

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sg = lane % L;                 // states sg * 4 .. sg * 4 + 3 (slot s: state s ^ 2 if swap) of ...
  const bool swap = lane & 16;
  const int cl = tid / L;                  // ... channel ch0 + cl; the thread's 16 bytes of a saved state: tid * 4
  const int blk = blockIdx.x, b = blockIdx.y, ch0 = blk * CB, ch = ch0 + cl;
  const bool live = ch < di;
  const int nchunk = (seq + CK - 1) / CK, nblk = gridDim.x;
  const size_t row0 = (size_t)b * seq;     // token rows of this batch row
  const bool whole_chunks = di % 4 == 0;

  float a2[NS], carry[NS], dA[NS];  // A log2 e, a_t+1 g_t+1 (dh_fin past the end), dA
  const bool has_dhfin = dh_fin != nullptr;
  if (live) {
    load4(A + (size_t)ch * DS + sg * NS, a2);
    if (has_dhfin) load4(dh_fin + ((size_t)b * di + ch) * DS + sg * NS, carry);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a2[s] = live ? a2[s] * LOG2E : 0.f;
    if (!(live && has_dhfin)) carry[s] = 0.f;
    dA[s] = 0.f;
  }
  swap_halves(a2, swap);
  swap_halves(carry, swap);

  auto stage = [&](int q) {  // tile q holds span nchunk - 1 - q; one cp.async group, empty past the end
    if (q < nchunk) {
      float* us = smem + q % 2 * Gm::STAGE;
      float* dts = us + Gm::TILE;
      float* dys = dts + Gm::TILE;
      float* bs = dys + Gm::TILE;  // B, then B with each chunk's 8-byte halves swapped
      float* cs = bs + 2 * Gm::BC;  // C, the same
      float* hsh = cs + 2 * Gm::BC;
      const int c = nchunk - 1 - q, t0 = c * CK;
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
          cp_async8(bs + Gm::BC + t * DS + qd, Bm + g + 2, in);
          cp_async8(bs + Gm::BC + t * DS + qd + 2, Bm + g, in);
          cp_async8(cs + Gm::BC + t * DS + qd, Cm + g + 2, in);
          cp_async8(cs + Gm::BC + t * DS + qd + 2, Cm + g, in);
        }
      }
      // the span's saved state: each thread its own 16 bytes, zero past di
      cp_async16(hsh + tid * NS, h_chk + (live ? (((size_t)b * nchunk + c) * di + ch) * DS + sg * NS : 0), live);
    }
    cp_async_commit();
  };

  stage(0);
  for (int q = 0; q < nchunk; ++q) {
    const int c = nchunk - 1 - q, t0 = c * CK, n = min(CK, seq - t0);
    cp_async_wait_all();
    __syncthreads();  // this tile has landed, and every thread is done with the previous one and with red
    stage(q + 1);     // into the buffer the previous tile used
    const float* us = smem + q % 2 * Gm::STAGE;
    const float* dts = us + Gm::TILE;
    const float* dys = dts + Gm::TILE;
    const float* bs = dys + Gm::TILE + (swap ? Gm::BC : 0);  // in the thread's slot order
    const float* cs = bs + 2 * Gm::BC;
    const float* hsh = dys + Gm::TILE + 4 * Gm::BC;

    // The span's old states h_t-1, t = t0 .. t0 + CK - 1, recomputed from the saved state by the forward's own
    // operations.
    float hs[CK][NS];
    {
      float h[NS];
      load4(hsh + tid * NS, h);
      swap_halves(h, swap);
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        float bq[NS];
        load4(bs + k * DS + sg * NS, bq);
        const float dt = dts[k * CB + cl], x = dt * us[k * CB + cl];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          if (k > 0) hs[k][s] = h[s];  // the span's first old state is its saved one
          h[s] = fmaf(ex2(dt * a2[s]), h[s], x * bq[s]);
        }
      }
    }

    // The span's tokens backwards.
    float pdu[2 * UD];  // item 2 j + 0: B.g, 2 j + 1: A log2 e a h_t-1 . g, of the group's token j
#pragma unroll
    for (int k = CK - 1; k >= 0; --k) {
      float bq[NS], cq[NS], pbc[2 * NS];  // slot s's g delta u at (s / 2) 4 + s % 2, its h_t dy 2 further
      load4(bs + k * DS + sg * NS, bq);
      load4(cs + k * DS + sg * NS, cq);
      const float dt = dts[k * CB + cl], x = dt * us[k * CB + cl], dyt = dys[k * CB + cl];
      float ho[NS];  // h_t-1; for the span's first token its saved state, read again rather than held
      if (k == 0) {
        load4(hsh + tid * NS, ho);
        swap_halves(ho, swap);
      } else {
#pragma unroll
        for (int s = 0; s < NS; ++s) ho[s] = hs[k][s];
      }
      float pu = 0.f, pa = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float a = ex2(dt * a2[s]);  // the decay again, bitwise the recompute's
        const float g = fmaf(cq[s], dyt, carry[s]);
        const float ga = g * a;
        const float gah = ga * ho[s];
        pu = fmaf(g, bq[s], pu);
        pa = fmaf(gah, a2[s], pa);
        dA[s] = fmaf(gah, dt, dA[s]);
        pbc[s / 2 * 4 + s % 2] = g * x;
        pbc[s / 2 * 4 + 2 + s % 2] = (k + 1 < CK ? hs[k + 1][s] : fmaf(a, ho[s], x * bq[s])) * dyt;  // h_t
        carry[s] = ga;
      }
      pdu[2 * (k % UD)] = pu;
      pdu[2 * (k % UD) + 1] = pa;

      // dB and dC of this token, over the warp's channels: lanes 16 apart hold the same states in swapped slots,
      // so the first halving step needs no select; two more (lane bits 8, 4) select.  Each lane then writes its
      // one item (slot bit 1 its own, then dB | dC, slot bit 0) to red.
#pragma unroll
      for (int j = 0; j < NS; ++j) pbc[j] += __shfl_xor_sync(0xffffffffu, pbc[j + NS], 16);
      reduce_scatter<8, 4, 2>(pbc, lane);
      red[(warp * CK + k) * 32 + lane] = pbc[0];

      // du and ddelta of the group's UD tokens: the sums over the channel's states, KEEP / 2 tokens a lane.
      if (k % UD == 0) {
        reduce_scatter<L / 2, 1, UD>(pdu, lane);
#pragma unroll
        for (int j = 0; j < KEEP / 2; ++j) {
          const int it = k + KEEP / 2 * sg + j;
          if (live && it < n) {
            const size_t o = (row0 + t0 + it) * di + ch;
            du[o] = dts[it * CB + cl] * pdu[2 * j];
            ddelta[o] = fmaf(us[it * CB + cl], pdu[2 * j], pdu[2 * j + 1] * LN2);
          }
        }
      }
    }

    // dB and dC of the span: each output's NW R items (the warps, and the lanes of a warp that differ in
    // channel only) added in a fixed order, one partial per block of channels.
    __syncthreads();
    for (int e = tid; e < CK * 2 * DS; e += NT) {
      const int i = e / (2 * DS), which = e / DS % 2, nn = e % DS, bit0 = nn % 2, bit1 = nn % NS / 2;
      const int lane0 = nn / NS + (bit1 ? 16 : 0) + (which ? 8 : 0) + (bit0 ? 4 : 0);
      const float* rp = red + i * 32 + lane0;
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < Gm::NW; ++w)
#pragma unroll
        for (int r = 0; r < Gm::R; ++r) acc[w % 2] += rp[w * CK * 32 + r * L];
      if (i < n) (which ? dC_part : dB_part)[(((size_t)b * nblk + blk) * seq + t0 + i) * DS + nn] = acc[0] + acc[1];
    }
  }

  swap_halves(carry, swap);
  swap_halves(dA, swap);
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
  static bool done[MAX_DEVICES] = {};  // one flag per instantiation and device
  cudaError_t err = opt_in_once(mamba_scan_bwd_kernel<DS>, Gm::SMEM, done);
  if (err != cudaSuccess) return err;
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
