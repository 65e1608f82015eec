// Mamba-1 selective scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `mamba_scan_pallas` (body `_scan_kernel`) in
// src/repro/kernels/mamba_scan.py, and computes the function of its jnp twin
// `ssm_chunked_scan` (src/repro/models/mamba.py), which the reference's
// prefill runs because it keeps the final state for decode: per batch row,
// channel d and state n, in f32,
//
//     h_t,d,n = exp(delta_t,d A_d,n) h_t-1,d,n + (delta_t,d u_t,d) B_t,n
//     y_t,d   = sum_n h_t,d,n C_t,n
//
// starting from h0 (or zero) and returning the final state.  The Pallas
// kernel's zero-state, no-state-out form is the special case h0 = 0.  As in
// the TPU kernel, the decay exp(delta A) and the drive delta u B are formed
// in registers and never stored at [B, S, di, ds].
//
// Bound.  Per token, channel and state one exponential and four f32
// operations (delta A, (delta u) B, the state's FMA, y's FMA); per token and
// channel 12 bytes of u, delta and y.  The special-function units give 16
// exponentials per SM and clock against 128 FP32 lanes, so the exponentials
// bound it: 0.128 ms at f32 B1 S4096 di8192 ds16 on an H100 SXM (537 M of
// them; the bytes would take 0.120 ms).  Delivery to the registers binds
// before that: shared memory returns 32 words per clock per SM however many
// lanes read one address, and every thread needs B and C of its states and u,
// delta of its channels each token, 2 / NS + 2 / DC words per state.
//
// Design.  The first version (0.912-0.953 ms at that shape, about 450
// clocks per token) gave each thread one channel and 4 states: per token it
// loaded u, delta and 8 scalars of B and C, called the accurate expf (a range
// reduction around one MUFU.EX2) and reduced y with two dependent shuffles and
// a lane-0 store before the next token could start, two warps per scheduler.
// Here:
// - the decay is ex2.approx.ftz(delta * A log2 e), A log2 e formed once per
//   thread: one FMUL and one MUFU per state and token;
// - each thread owns DC = 1 channel x NS = 4 states: one float4 each of B and C
//   per token (2.5 words per state), and 8 warps per SM at B1 di8192 ds16, two
//   per scheduler.  Two channels per thread halve the B and C words but leave
//   one warp per scheduler, which measures slower (scripts/scan_variants.py);
// - the token loop works in groups of U = 8 tokens with no dependence between
//   tokens but the state's FMA; the y partials of a group stay in registers
//   and meet in one reduce-scatter across the ds / NS lanes of a channel, after
//   which each lane holds finished (token, channel) sums and stores them (a
//   warp's stores of a token cover neighbouring channels); a step takes two
//   groups, and a tile of at most U tokens (a decode step) one;
// - tiles of TT = 32 tokens of u, delta (the block's CB channels) and B, C are
//   staged with cp.async, double buffered (40 KB of shared memory, within the
//   default 48 KB), instead of register prefetch.  Tokens past the end of the
//   sequence and channels past di are zero-filled: delta = 0 makes a token an
//   identity (decay 1, drive 0), so the loop runs in whole steps and only the
//   stores look at the ends.
// Probes in scripts/scan_variants.py that drop the MUFU or the per-token loads
// show that the loads, not the exponentials, hold this design (PERF.md).
// A call of at most U = 8 tokens (a decode step), chosen from seq, takes a short
// geometry: 8 states per thread, so that half the threads (at most 128
// registers each) fit a B4 di8192 batch on the card in one wave, one group and
// one 16-token tile.  A thread's states are 16-byte chunks interleaved across
// the lanes of its channel, so that a warp's h0 loads and h_fin stores fill
// whole 32-byte sectors.
//
// Training form (mamba_scan_forward_train).  The same kernel, instantiated with TRAIN,
// also writes the state before every CK = 16 tokens (mamba_scan_common.cuh) into h_chk
// [B, ceil(S / CK), di, ds], for the backward (mamba_scan_bwd.cu) to recompute the old
// states from; the first is h0 (or zero).  A step of the token loop is 2 U = CK tokens,
// so the state is saved before each step, from the registers that hold it: each lane
// stores its 16-byte chunk of 4 neighbouring states, and a warp's stores cover
// 8 channels x 16 states, 512 neighbouring bytes, in whole 32-byte sectors (ds = 16;
// at ds 4 and 8 a warp's 32 channels or 16 channels are as contiguous).  At f32 B4 S2048
// di8192 ds16 the saved states are 268 MB, 0.080 ms at the memory rate.  The training
// form exists for ds in {4, 8, 16}, the backward's instantiations.
//
// Inputs, all float32, contiguous and 16-byte aligned: u, delta [B, S, di];
// A [di, ds]; B, C [B, S, ds]; h0 [B, di, ds] (optional).  Outputs, float32:
// y [B, S, di], h_fin [B, di, ds] and, in the training form, h_chk.  Any di: rows of
// u and delta that are not whole 16-byte chunks (di % 4 != 0) are staged 4 bytes at
// a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_common.cuh"  // CK, LOG2E, ex2

namespace {

constexpr int DC = 1;      // channels per thread
constexpr int CB = 64;     // channels per block
constexpr int U = 8;       // tokens per group: one reduce-scatter of the y partials
constexpr int NSTAGE = 2;  // tiles in the shared-memory ring: NSTAGE - 1 in flight while one is computed
static_assert(2 * U == CK, "the training form saves the state before each step of 2 U tokens");

// A call of at most U tokens (a decode step) takes the short geometry: 8 states per thread
// instead of 4, half the threads, so that a decode batch's blocks fit the card in one
// wave, and tiles of one step.
template <int DS, bool SHORT>
struct Geometry {
  static constexpr int NS = SHORT && DS >= 8 ? 8 : 4;  // states per thread
  static constexpr int TT = SHORT ? 2 * U : 32;        // tokens per staged tile
  static constexpr int L = DS / NS;        // lanes that share a thread's DC channels, one per NS states
  static constexpr int LANE_GROUPS = 32 / L;  // groups of L lanes in a warp, DC channels each
  static constexpr int NT = 32 * (CB / (DC * LANE_GROUPS));
  static constexpr int KEEP = DC * U / L;  // (token, channel) sums each lane holds after a group's reduction
  static constexpr int UD = TT * CB, BC = TT * DS;  // floats of u (or delta) and of B (or C) in a tile
  static constexpr int STAGE = 2 * UD + 2 * BC;
  static constexpr int SMEM = NSTAGE * STAGE * 4;  // the ring, in bytes
  static_assert(L >= 1 && L <= DC * U && CB % (DC * LANE_GROUPS) == 0 && TT % (2 * U) == 0 && TT % CK == 0, "tile");
  static_assert((TT * CB / 4) % NT == 0 && TT * CB % NT == 0, "staging");
  static_assert(SMEM <= 48 * 1024, "within the default dynamic shared memory, no opt-in");
};

template <int N>
__device__ __forceinline__ void load(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    o[0] = p[0];
  }
}

// A thread's NS states of a channel, NS / 4 chunks of 4: chunk q holds states (q L + sg) * 4
// .. + 3, so that the L lanes of a channel cover 4 L neighbouring states with one 16-byte
// access each, and a warp's loads and stores of a chunk fill whole 32-byte sectors.
template <int L, int NS>
__device__ __forceinline__ void load_states(const float* row, int sg, float (&o)[NS]) {
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(row + (q * L + sg) * 4);
    o[4 * q] = x.x, o[4 * q + 1] = x.y, o[4 * q + 2] = x.z, o[4 * q + 3] = x.w;
  }
}
template <int L, int NS>
__device__ __forceinline__ void store_states(float* row, int sg, const float (&o)[NS]) {
#pragma unroll
  for (int q = 0; q < NS / 4; ++q)
    *reinterpret_cast<float4*>(row + (q * L + sg) * 4) = float4{o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]};
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
template <int N>  // until at most the N newest groups are in flight
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// One halving step of a reduce-scatter across the lanes that differ in bit D: p[0 .. 2M)
// in, the lane's half p[0 .. M) summed with the partner's out (the upper half if lane & D).
// Recursing down to D = 1 leaves p[0 .. KEEP) = the sums of items KEEP * (lane % 2D) + i.
template <int D, int M, int NI>
__device__ __forceinline__ void reduce_scatter(float (&p)[NI], int lane) {
  if constexpr (D >= 1) {
    const bool up = lane & D;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = up ? p[i] : p[i + M];
      const float keep = up ? p[i + M] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, D);
    }
    reduce_scatter<D / 2, M / 2>(p, lane);
  }
}

// The U tokens from t_first on, for this thread's DC channels x NS states: the state update
// and the partial y of its states into p (item k * DC + c = token t_first + k, channel c).
template <int DS, bool SHORT, int NS = Geometry<DS, SHORT>::NS, int L = Geometry<DS, SHORT>::L>
__device__ __forceinline__ void scan_group(const float* us, const float* dts, const float* bs, const float* cs,
                                           int t_first, int sg, int cl0, const float (&a2)[DC][NS],
                                           float (&h)[DC][NS], float (&p)[DC * U]) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int t = t_first + k;
    float bq[NS], cq[NS], dt[DC], uu[DC];
    load_states<L>(bs + t * DS, sg, bq);
    load_states<L>(cs + t * DS, sg, cq);
    load(dts + t * CB + cl0, dt);
    load(us + t * CB + cl0, uu);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float du = dt[c] * uu[c];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float decay = ex2(dt[c] * a2[c][s]);
        h[c][s] = fmaf(decay, h[c][s], du * bq[s]);
        acc = fmaf(h[c][s], cq[s], acc);
      }
      p[k * DC + c] = acc;
    }
  }
}

// Short calls: at most 128 registers per thread (512 threads' worth per block count), so that a
// decode batch's blocks fit the card in one wave.  Long calls: one block per SM asked, which
// ptxas takes as leave to use more registers than its default for these block sizes (at ds = 32
// the default spilled).
template <int DS, bool SHORT, bool TRAIN>
__global__ void __launch_bounds__(Geometry<DS, SHORT>::NT, SHORT ? 512 / Geometry<DS, SHORT>::NT : 1)
    mamba_scan_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_fin, float* __restrict__ h_chk, int seq, int di) {
  using Gm = Geometry<DS, SHORT>;
  constexpr int NS = Gm::NS, TT = Gm::TT, L = Gm::L, NT = Gm::NT, KEEP = Gm::KEEP;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid % 32;
  const int sg = lane % L;                                  // which chunk of each 4 L states is this thread's
  const int cl0 = (tid / 32 * Gm::LANE_GROUPS + lane / L) * DC;  // channels ch0 + cl0 .. + DC - 1
  const int b = blockIdx.y, ch0 = blockIdx.x * CB;
  const size_t row0 = (size_t)b * seq;                      // token rows of this batch row
  const bool whole_chunks = di % 4 == 0;

  float a2[DC][NS], h[DC][NS];  // A log2 e and the state
  const bool has_h0 = h0 != nullptr;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int ch = ch0 + cl0 + c;
    if (ch < di) {
      load_states<L>(A + (size_t)ch * DS, sg, a2[c]);
      if (has_h0) load_states<L>(h0 + ((size_t)b * di + ch) * DS, sg, h[c]);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      a2[c][s] = ch < di ? a2[c][s] * LOG2E : 0.f;
      if (!(ch < di && has_h0)) h[c][s] = 0.f;
    }
  }

  const int ntiles = (seq + TT - 1) / TT;
  const int nchk = (seq + CK - 1) / CK;
  auto save = [&](int t) {  // the state before token t, a multiple of CK
    if constexpr (TRAIN) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int ch = ch0 + cl0 + c;
        if (ch < di) store_states<L>(h_chk + (((size_t)b * nchk + t / CK) * di + ch) * DS, sg, h[c]);
      }
    }
  };
  auto stage = [&](int tile) {  // one cp.async group per tile; an empty one past the end
    if (tile >= ntiles) {
      cp_async_commit();
      return;
    }
    float* us = smem + tile % NSTAGE * Gm::STAGE;
    float* dts = us + Gm::UD;
    float* bs = dts + Gm::UD;
    float* cs = bs + Gm::BC;
    const int t0 = tile * TT;
    if (whole_chunks) {
      constexpr int CH = CB / 4;
#pragma unroll
      for (int i = 0; i < TT * CH / NT; ++i) {
        const int e = tid + i * NT, t = e / CH, q = e % CH * 4;
        const bool in = t0 + t < seq && ch0 + q < di;
        const size_t g = in ? (row0 + t0 + t) * di + ch0 + q : 0;
        cp_async16(us + t * CB + q, u + g, in);
        cp_async16(dts + t * CB + q, delta + g, in);
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < TT * CB / NT; ++i) {
        const int e = tid + i * NT, t = e / CB, q = e % CB;
        const bool in = t0 + t < seq && ch0 + q < di;
        const size_t g = in ? (row0 + t0 + t) * di + ch0 + q : 0;
        cp_async4(us + t * CB + q, u + g, in);
        cp_async4(dts + t * CB + q, delta + g, in);
      }
    }
    constexpr int BCH = TT * DS / 4;  // B and C: TT rows of DS floats, BCH 16-byte chunks each
#pragma unroll
    for (int i = 0; i < (BCH + NT - 1) / NT; ++i) {
      const int e = tid + i * NT, t = e / (DS / 4), q = e % (DS / 4) * 4;
      const bool in = t0 + t < seq;
      const size_t g = in ? (row0 + t0 + t) * DS + q : 0;
      if (e < BCH) {
        cp_async16(bs + t * DS + q, Bm + g, in);
        cp_async16(cs + t * DS + q, Cm + g, in);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) stage(tile);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TT, n = min(TT, seq - t0);
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // this tile has landed, and every thread is done with the previous one
    stage(tile + NSTAGE - 1);  // into the buffer the previous tile used
    const float* us = smem + tile % NSTAGE * Gm::STAGE;
    const float* dts = us + Gm::UD;
    const float* bs = dts + Gm::UD;
    const float* cs = bs + Gm::BC;

    // Token loop: two groups of U tokens per step, each computed and then reduced; a tile
    // of at most U tokens (a decode step) takes one group, and a short call has no other.
    auto finish = [&](int t_first, float (&p)[DC * U]) {
      reduce_scatter<L / 2, DC * U / 2>(p, lane);
#pragma unroll
      for (int i = 0; i < KEEP; ++i) {
        const int item = KEEP * sg + i, t = t_first + item / DC, ch = ch0 + cl0 + item % DC;
        if (t < n && ch < di) y[(row0 + t0 + t) * di + ch] = p[i];
      }
    };
    if (SHORT || n <= U) {
      save(t0);
      float pa[DC * U];
      scan_group<DS, SHORT>(us, dts, bs, cs, 0, sg, cl0, a2, h, pa);
      finish(0, pa);
      continue;
    }
    for (int tt = 0; tt < n; tt += 2 * U) {
      save(t0 + tt);
      float pa[DC * U], pb[DC * U];
      scan_group<DS, SHORT>(us, dts, bs, cs, tt, sg, cl0, a2, h, pa);
      finish(tt, pa);
      scan_group<DS, SHORT>(us, dts, bs, cs, tt + U, sg, cl0, a2, h, pb);
      finish(tt + U, pb);
    }
  }

#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int ch = ch0 + cl0 + c;
    if (ch < di) store_states<L>(h_fin + ((size_t)b * di + ch) * DS, sg, h[c]);
  }
}

template <int DS, bool SHORT, bool TRAIN>
cudaError_t launch_as(const float* u, const float* delta, const float* A, const float* Bm,
                      const float* Cm, const float* h0, float* y, float* h_fin, float* h_chk, int batch,
                      int seq, int di, cudaStream_t stream) {
  using Gm = Geometry<DS, SHORT>;
  const dim3 grid((di + CB - 1) / CB, batch);
  mamba_scan_kernel<DS, SHORT, TRAIN><<<grid, Gm::NT, Gm::SMEM, stream>>>(u, delta, A, Bm, Cm, h0, y, h_fin,
                                                                           h_chk, seq, di);
  return cudaGetLastError();
}

template <int DS, bool TRAIN>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* h_fin, float* h_chk, int batch,
                   int seq, int di, cudaStream_t stream) {
  return seq <= U ? launch_as<DS, true, TRAIN>(u, delta, A, Bm, Cm, h0, y, h_fin, h_chk, batch, seq, di, stream)
                  : launch_as<DS, false, TRAIN>(u, delta, A, Bm, Cm, h0, y, h_fin, h_chk, batch, seq, di, stream);
}

bool bad_shape(int batch, int S, int di) { return batch <= 0 || S <= 0 || di <= 0 || batch > 65535; }

}  // namespace

// ds must be 4, 8, 16 or 32; h0 may be null (zero state).
// Returns a cudaError_t (0 = launched).
extern "C" int mamba_scan_forward(const void* u, const void* delta, const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y, void* h_fin, int batch,
                                  int S, int di, int ds, void* stream) {
  if (bad_shape(batch, S, di)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* df = static_cast<const float*>(delta);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(h_fin);
  switch (ds) {
    case 4: return (int)launch<4, false>(uf, df, af, bf, cf, hf, yf, ff, nullptr, batch, S, di, st);
    case 8: return (int)launch<8, false>(uf, df, af, bf, cf, hf, yf, ff, nullptr, batch, S, di, st);
    case 16: return (int)launch<16, false>(uf, df, af, bf, cf, hf, yf, ff, nullptr, batch, S, di, st);
    case 32: return (int)launch<32, false>(uf, df, af, bf, cf, hf, yf, ff, nullptr, batch, S, di, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The training form: also h_chk [B, ceil(S / CK), di, ds], the state before every CK tokens.
// ds must be 4, 8 or 16; h0 may be null (zero state).  Returns a cudaError_t (0 = launched).
extern "C" int mamba_scan_forward_train(const void* u, const void* delta, const void* A, const void* Bm,
                                        const void* Cm, const void* h0, void* y, void* h_fin, void* h_chk,
                                        int batch, int S, int di, int ds, void* stream) {
  if (bad_shape(batch, S, di) || h_chk == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* df = static_cast<const float*>(delta);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(h_fin);
  float* kf = static_cast<float*>(h_chk);
  switch (ds) {
    case 4: return (int)launch<4, true>(uf, df, af, bf, cf, hf, yf, ff, kf, batch, S, di, st);
    case 8: return (int)launch<8, true>(uf, df, af, bf, cf, hf, yf, ff, kf, batch, S, di, st);
    case 16: return (int)launch<16, true>(uf, df, af, bf, cf, hf, yf, ff, kf, batch, S, di, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mamba_scan_checkpoint() { return CK; }

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
