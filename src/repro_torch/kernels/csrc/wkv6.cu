// RWKV-6 WKV recurrence for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (body `_wkv_kernel`) in
// src/repro/kernels/rwkv6_scan.py, and computes the function of its jnp twin
// `wkv_chunked` (src/repro/models/rwkv6.py), which the reference's prefill and
// decode run because they carry a state: per head, with an f32 C x C state S,
//
//     out_t,j = sum_i r_t,i S_ij + (sum_i r_t,i u_i k_t,i) v_t,j
//     S_ij   <- w_t,i S_ij + k_t,i v_t,j
//
// starting from s0 (or zero) and returning the final state.  The Pallas
// kernel's zero-state, no-state-out form is the special case s0 = 0.
//
// Form.  The recurrence runs token by token and needs no exponential, so it
// cannot overflow at the full model's decays (a chunked matrix form would need
// exp(+-L) factors, and a bf16 or TF32 product would miss the 1e-4 gate).  The
// bonus term factors as v_t,j (r_t . u o k_t), one dot product per token and
// head, computed once per staged tile; per state element and token there are
// then the three f32 operations the bound counts: acc_j += r_i S_ij on the old
// state, kv = k_i v_j, S_ij = w_i S_ij + kv.
//
// Bound.  Per token and head 5 C^2 f32 FLOP (those three operations) against
// r, k, v (2 or 4 bytes each), w and out (4 bytes) of C channels: at C = 64 the
// operations bound it (0.080 ms at bf16 B1 S4096 H64 C64 on an H100 SXM at 67
// TFLOP/s; the bytes would take 0.070 ms).  What binds before the FP32 pipes is
// delivery to the registers: shared memory returns 32 words per clock per SM
// however many lanes read one address (an LDS.128 holds it 4 clocks), a quarter
// of the FMA rate, and the reduction's shuffles cost about as much per word.
// So each loaded word has to feed several FMAs, and few partial sums may cross
// lanes.
//
// Design.  The first version (0.689-0.699 ms at that shape, about 300
// clocks per token) gave each thread one column and a quarter of the rows and
// loaded one broadcast float4 (r_i, k_i, w_i) per row and token: 16 LDS.128 per
// warp and token, 256 clocks of delivery per token on the SM's 4 warps.  Here
// each thread owns a patch of RI x JC state elements in registers (4 x 2 at
// C = 64): per token it loads RI values each of r, k, w and JC of v (9 words in
// bf16, widened by shifts; 14 in f32) for 3 RI JC = 24 FMAs.  The G = C / RI
// threads that share a column are lanes of one warp; their partial outputs of a
// group of TK = G / JC tokens (G values per lane) meet in a reduce-scatter of
// log2 G shuffle steps, after which each lane holds one finished (token,
// column) output, adds the bonus and stores it (the lanes of a token write
// neighbouring columns).  A block covers all C rows of JB columns: at B1 H64
// C64, 128 blocks of 8 warps, two per scheduler.  Tiles of TT tokens of r, k, w
// and the block's v are staged as stored (bf16 or f32) with cp.async, double
// buffered (TT = 32: 36 KB of shared memory in bf16 at C = 64; f32 takes 16-token
// tiles, 28 KB, so that no instantiation needs the opt-in above the default
// 48 KB).  The tile's prologue computes the bonus per token and turns the tokens
// past the end of the sequence into identities (w = 1, and k = v = 0 from
// cp.async's zero fill), so the token loop runs in whole steps of two groups
// and only the stores look at the end.  scripts/scan_variants.py times the
// alternatives (4 x 4, 8 x 2 and 2 x 4 patches, ring depth, one group per step)
// and probes that drop the per-token loads or the reduce-scatter: those two hold
// this design, each about a third of its time (PERF.md).
//
// Short calls.  A call of at most SHORT_SEQ = 8 tokens (a decode step) is bound
// by moving the state, C x C f32 in and out per head, not by the recurrence.
// There the long patch loses: its 16 row-group lanes per column make each
// warp's state store touch 16 partly written 32-byte sectors, and 256-thread
// blocks at 101 registers take two waves at B4 H64 (12.4 us against the first
// version's 3.8).  So a short call, chosen from seq, takes a short patch: 16
// rows x 1 column per thread at C = 64 (4 lanes per column, 8 neighbouring
// columns per warp, so every state load and store fills 4 whole sectors),
// 128-thread blocks that fit the card in one wave, one 8-token tile, and
// tokens past the end skipped rather than computed as identities.
//
// Training form.  wkv6_forward_train also writes the state before every CK = 16
// tokens, s_chk [B, H, ceil(S / CK), C, C] in f32 (the first is s0, or zero), from
// which the backward (csrc/wkv6_bwd.cu) recomputes the old states it needs.  It is an
// instantiation of its own (TRAIN, in the geometry serving would take), so the serving
// form's code is untouched and its out and final state are the serving form's bitwise.  A boundary falls at the start of a tile or, in 32-token tiles,
// at the start of the step that begins its second half (2 TK divides CK at every C).
// There each thread puts its patch into a C x JB staging buffer in shared memory (8 KB
// at C = 64, beside the 36 KB ring in bf16 and 28 KB in f32), and the block stores it
// as whole 16-byte pieces, eight lanes to each 128-byte row segment.  The buffer's
// pairs of columns are XOR-swizzled by row group, so that the G lanes of a column
// write distinct banks and each reader's 16-byte piece is one aligned chunk (its
// halves swapped on odd groups).  A save at a tile's start costs no barrier of its
// own; one in mid-tile two.  At the training shape (bf16 B4 S2048 H64 C64) the saved
// states are 537 MB, which adds 0.160 ms to the bytes bound.  The earlier store, each
// thread's 4 x 2 patch as 8-byte pieces (16 half-filled sectors a warp store), cost
// 0.45 ms over the serving form there (PERF.md).
//
// Inputs: r, k, v [B, S, H, C] in f32 or bf16; w [B, S, H, C], u [H, C] and
// s0 [B, H, C, C] (optional) in f32.  Outputs, both f32: out [B, S, H, C] and
// s_fin [B, H, C, C], and s_chk in the training form.  All contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_common.cuh"  // CK

namespace {

constexpr int NSTAGE = 2;     // tiles in the shared-memory ring: NSTAGE - 1 in flight while one is computed
constexpr int SHORT_SEQ = 8;  // calls of at most this many tokens (decode steps) take the short patch

// Each thread's patch of the state, RI rows x JC columns, and the JB columns of a block.
// The short patch (a quarter of one column's rows per thread) halves the threads of the
// long one at C = 64, so that a decode batch's blocks fit the card in one wave, and its
// state loads and stores cover whole 32-byte sectors.
template <int C, bool SHORT> struct Patch;
template <> struct Patch<64, false> { static constexpr int RI = 4, JC = 2, JB = 32; };
template <> struct Patch<32, false> { static constexpr int RI = 4, JC = 4, JB = 32; };
template <> struct Patch<16, false> { static constexpr int RI = 4, JC = 2, JB = 16; };
template <> struct Patch<8, false> { static constexpr int RI = 2, JC = 1, JB = 8; };
template <int C> struct Patch<C, true> { static constexpr int RI = C / 4, JC = 1, JB = C < 32 ? C : 32; };

// Bytes of shared memory for tiles of tt tokens: the ring of r, k, w and the block's v, and the bonus.
template <typename T, int C, int JB>
constexpr int ring_bytes(int tt) {
  return NSTAGE * tt * (C * (2 * (int)sizeof(T) + 4) + JB * (int)sizeof(T)) + tt * 4;
}

template <typename T, int C, bool SHORT, bool TRAIN = false>
struct Geometry {
  static constexpr int RI = Patch<C, SHORT>::RI, JC = Patch<C, SHORT>::JC, JB = Patch<C, SHORT>::JB;
  static constexpr int G = C / RI;        // lanes that share a column, one per row group
  static constexpr int WCOLS = 32 / G * JC;  // columns of a warp
  static constexpr int NT = 32 * (JB / WCOLS);
  static constexpr int TK = G / JC;       // tokens per group: one reduce-scatter of G (token, column) sums
  static constexpr int SAVE = TRAIN ? C * JB * 4 : 0;  // the training form's staged state, f32
  // tokens per staged tile: one step of two groups for a short call; else 32, or 16 where
  // 32 would pass the default 48 KB of shared memory (f32 at C = 64), which needs no opt-in
  static constexpr int TT = SHORT ? 2 * TK : ring_bytes<T, C, JB>(32) + SAVE <= 48 * 1024 ? 32 : 16;
  static constexpr int LPT = NT / TT;     // prologue: lanes per token ...
  static constexpr int RP = C / LPT;      // ... and rows per lane
  static constexpr int R_BYTES = TT * C * (int)sizeof(T), W_BYTES = TT * C * 4;
  static constexpr int V_BYTES = TT * JB * (int)sizeof(T);
  static constexpr int STAGE = 2 * R_BYTES + W_BYTES + V_BYTES;  // r, k, w, v of one tile
  static constexpr int SMEM = ring_bytes<T, C, JB>(TT) + SAVE;
  static_assert(G <= 32 && 32 % G == 0 && JB % WCOLS == 0 && TT % (2 * TK) == 0, "tile");
  static_assert(NT % TT == 0 && LPT <= 32 && RP % 2 == 0 && V_BYTES % 16 == 0, "prologue");
  static_assert(SMEM == NSTAGE * STAGE + TT * 4 + SAVE && SMEM <= 48 * 1024, "within the default shared memory");
  static_assert(!TRAIN || (JB % 4 == 0 && (SHORT || TT == CK || TT == 2 * CK)), "saved states at tile starts or halves");
  static_assert(!SHORT || TT >= SHORT_SEQ, "a short call is one tile");
  static_assert(SHORT || (CK % (2 * TK) == 0 && TT % CK == 0), "a saved state falls at the start of a step");
};

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// N consecutive values at p (aligned to their size) as f32: float4 / float2 loads,
// bf16 pairs widened by shifts.
template <int N>
__device__ __forceinline__ void load(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = x.x, o[4 * q + 1] = x.y, o[4 * q + 2] = x.z, o[4 * q + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    o[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      o[4 * q] = bf16_lo(x.x), o[4 * q + 1] = bf16_hi(x.x), o[4 * q + 2] = bf16_lo(x.y), o[4 * q + 3] = bf16_hi(x.y);
    }
  } else if constexpr (N == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    o[0] = bf16_lo(x), o[1] = bf16_hi(x);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read) when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>  // until at most the N newest groups are in flight
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Rows t0 .. t0 + TT - 1 of one (batch, head) slice, N elements from column c0 on, into
// dst[TT][N]; src + base + t * stride is row t.  Rows at or past seq are zero-filled.
template <int N, int NT, int TT, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, size_t base, size_t stride, int t0,
                                           int seq, int tid) {
  constexpr int PER = 16 / (int)sizeof(E), CH = N / PER;  // elements per chunk, chunks per row
  static_assert(CH * PER == N, "rows are whole 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (TT * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT, t = e / CH, q = e % CH;
    const bool in = t0 + t < seq;
    if (e < TT * CH)
      cp_async16(dst + t * N + q * PER, src + (in ? base + (size_t)(t0 + t) * stride + q * PER : 0), in);
  }
}

// One halving step of a reduce-scatter of partial sums across the lanes that differ in
// bit D: p[0 .. 2D) in, the lane's half p[0 .. D) summed with the partner's out (the upper
// half if lane & D).  From D = G / 2 down to 1 (compile-time indices, so p stays in
// registers), p[0] ends as the full sum of item lane % G.
template <int D, int G>
__device__ __forceinline__ void reduce_scatter(float (&p)[G], int lane) {
  if constexpr (D >= 1) {
    const bool up = lane & D;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float send = up ? p[i] : p[i + D];
      const float keep = up ? p[i + D] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, D);
    }
    reduce_scatter<D / 2>(p, lane);
  }
}

// The TK tokens from t_first on, for this thread's patch: the partial outputs of its RI rows
// into p (item tk * JC + c = token t_first + tk, column c), and the state update.  The long
// geometry runs a tile's tokens past n as the identities they were made; a short call skips
// them (a decode step computes one token, not a group).
template <typename T, int C, bool SHORT, typename Gm = Geometry<T, C, SHORT>>
__device__ __forceinline__ void wkv_group(const T* rs, const T* ks, const float* ws, const T* vs, int t_first,
                                          int n, int row0, int jl0, float (&st)[Gm::RI][Gm::JC],
                                          float (&p)[Gm::G]) {
  constexpr int RI = Gm::RI, JC = Gm::JC, JB = Gm::JB;
#pragma unroll
  for (int tk = 0; tk < Gm::TK; ++tk) {
    const int t = t_first + tk;
    if (SHORT && t >= n) {
#pragma unroll
      for (int c = 0; c < JC; ++c) p[tk * JC + c] = 0.f;
      continue;
    }
    float rr[RI], kk[RI], ww[RI], vv[JC];
    load(rs + t * C + row0, rr);
    load(ks + t * C + row0, kk);
    load(ws + t * C + row0, ww);
    load(vs + t * JB + jl0, vv);
#pragma unroll
    for (int c = 0; c < JC; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        acc = fmaf(rr[a], st[a][c], acc);                 // r_i S_ij, the old state
        st[a][c] = fmaf(ww[a], st[a][c], kk[a] * vv[c]);  // w_i S_ij + k_i v_j
      }
      p[tk * JC + c] = acc;
    }
  }
}

template <typename T, int C, bool SHORT, bool TRAIN>
__global__ void __launch_bounds__(Geometry<T, C, SHORT>::NT, SHORT ? 4 : 1) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ s_fin, float* __restrict__ s_chk, int seq, int H) {
  using Gm = Geometry<T, C, SHORT, TRAIN>;
  constexpr int RI = Gm::RI, JC = Gm::JC, JB = Gm::JB, G = Gm::G, NT = Gm::NT, TK = Gm::TK, TT = Gm::TT;
  constexpr int LPT = Gm::LPT, RP = Gm::RP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bonus = reinterpret_cast<float*>(smem + NSTAGE * Gm::STAGE);

  const int h = blockIdx.y, b = blockIdx.z, col0 = blockIdx.x * JB;
  const int tid = threadIdx.x, lane = tid % 32;
  const int rg = lane % G;                                    // this thread's rows: row0 .. row0 + RI - 1
  const int row0 = rg * RI;
  const int jl0 = tid / 32 * Gm::WCOLS + lane / G * JC;     // its columns: col0 + jl0 .. + JC - 1
  const size_t stride = (size_t)H * C;                       // between tokens
  const size_t base = (size_t)b * seq * stride + (size_t)h * C;  // (b, t = 0, h, 0)
  const size_t state_base = ((size_t)b * H + h) * C * C;

  // the prologue's share of the bonus: LPT lanes per token, RP rows each, u of those rows
  const int tp = tid / LPT, prow = tid % LPT * RP;
  float up[RP];
  load(u + h * C + prow, up);

  float st[RI][JC];
  const bool has_s0 = s0 != nullptr;
#pragma unroll
  for (int a = 0; a < RI; ++a) {
    if (has_s0) {
      load(s0 + state_base + (size_t)(row0 + a) * C + col0 + jl0, st[a]);
    } else {
#pragma unroll
      for (int c = 0; c < JC; ++c) st[a][c] = 0.f;
    }
  }

  // The training form's saved states: each thread's patch into the staging buffer [C][JB], pairs
  // of columns XOR (row / RI) % (JB / 2); then the block's C x JB state to s_chk as 16-byte pieces.
  float* saved = reinterpret_cast<float*>(smem + NSTAGE * Gm::STAGE + TT * 4);
  auto put_saved = [&]() {
#pragma unroll
    for (int a = 0; a < RI; ++a) {
      const int row = row0 + a, m = 2 * (row / RI % (JB / 2));
      if constexpr (JC == 1) {
        saved[row * JB + (jl0 ^ m)] = st[a][0];
      } else {
#pragma unroll
        for (int c = 0; c < JC; c += 2)
          *reinterpret_cast<float2*>(saved + row * JB + ((jl0 + c) ^ m)) = float2{st[a][c], st[a][c + 1]};
      }
    }
  };
  const size_t chk_base = ((size_t)b * H + h) * ((seq + CK - 1) / CK) * C * C + col0;
  auto store_saved = [&](int t) {  // the state before token t, a multiple of CK
    float* dst = s_chk + chk_base + (size_t)(t / CK) * C * C;
    for (int e = tid; e < C * JB / 4; e += NT) {
      const int row = e / (JB / 4), cq = e % (JB / 4), m = row / RI % (JB / 2);
      float4 x = *reinterpret_cast<const float4*>(saved + row * JB + 4 * (cq ^ (m >> 1)));
      if (m & 1) x = float4{x.z, x.w, x.x, x.y};
      *reinterpret_cast<float4*>(dst + (size_t)row * C + 4 * cq) = x;
    }
  };

  auto tile_ptrs = [&](int tile, T*& rs, T*& ks, float*& ws, T*& vs) {
    unsigned char* p = smem + tile % NSTAGE * Gm::STAGE;
    rs = reinterpret_cast<T*>(p);
    ks = reinterpret_cast<T*>(p + Gm::R_BYTES);
    ws = reinterpret_cast<float*>(p + 2 * Gm::R_BYTES);
    vs = reinterpret_cast<T*>(p + 2 * Gm::R_BYTES + Gm::W_BYTES);
  };
  const int ntiles = (seq + TT - 1) / TT;
  auto stage = [&](int tile) {  // one cp.async group per tile; an empty one past the end
    if (tile < ntiles) {
      T *rs, *ks, *vs;
      float* ws;
      tile_ptrs(tile, rs, ks, ws, vs);
      const int t0 = tile * TT;
      stage_rows<C, NT, TT>(rs, r, base, stride, t0, seq, tid);
      stage_rows<C, NT, TT>(ks, k, base, stride, t0, seq, tid);
      stage_rows<C, NT, TT>(ws, w, base, stride, t0, seq, tid);
      stage_rows<JB, NT, TT>(vs, v, base + col0, stride, t0, seq, tid);
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
    if constexpr (TRAIN) put_saved();  // the state before t0: the last save's readers are past the barrier
    T *rs, *ks, *vs;
    float* ws;
    tile_ptrs(tile, rs, ks, ws, vs);

    // Prologue: bonus_t = r_t . (u o k_t), LPT lanes per token; tokens past seq become identities.
    {
      float rr[RP], kk[RP];
      load(rs + tp * C + prow, rr);
      load(ks + tp * C + prow, kk);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < RP; ++i) acc = fmaf(rr[i], up[i] * kk[i], acc);
#pragma unroll
      for (int d = LPT / 2; d >= 1; d /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, d);
      if (tid % LPT == 0) bonus[tp] = acc;
      if (tp >= n) {
#pragma unroll
        for (int i = 0; i < RP; ++i) ws[tp * C + prow + i] = 1.f;
      }
    }
    __syncthreads();
    if constexpr (TRAIN) store_saved(t0);

    // Token loop: two groups of TK tokens per step, each computed and then reduced; a tile
    // of at most TK tokens (a decode step) takes one group.
    auto finish = [&](int t_first, float (&p)[G]) {
      reduce_scatter<G / 2>(p, lane);
      const int t = t_first + rg / JC, jl = jl0 + rg % JC;  // the output this lane now holds
      const float vj = to_f32(vs[t * JB + jl]);
      if (t < n) out[base + (size_t)(t0 + t) * stride + col0 + jl] = p[0] + bonus[t] * vj;
    };
    if (n <= TK) {
      float pa[G];
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, 0, n, row0, jl0, st, pa);
      finish(0, pa);
      continue;
    }
    for (int tt = 0; tt < n; tt += 2 * TK) {
      if constexpr (TRAIN && TT > CK) {
        if (tt == CK) {      // the state before the tile's second half
          __syncthreads();   // the staged state before t0 has been stored
          put_saved();
          __syncthreads();
          store_saved(t0 + tt);
        }
      }
      float pa[G], pb[G];
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt, n, row0, jl0, st, pa);
      finish(tt, pa);
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt + TK, n, row0, jl0, st, pb);
      finish(tt + TK, pb);
    }
  }

#pragma unroll
  for (int a = 0; a < RI; ++a) {
#pragma unroll
    for (int c = 0; c < JC; ++c) s_fin[state_base + (size_t)(row0 + a) * C + col0 + jl0 + c] = st[a][c];
  }
}

template <typename T, int C, bool SHORT, bool TRAIN>
cudaError_t launch_as(const void* r, const void* k, const void* v, const float* w, const float* u,
                      const float* s0, float* out, float* s_fin, float* s_chk, int B, int seq, int H,
                      cudaStream_t stream) {
  using Gm = Geometry<T, C, SHORT, TRAIN>;
  const dim3 grid(C / Gm::JB, H, B);
  wkv6_kernel<T, C, SHORT, TRAIN><<<grid, Gm::NT, Gm::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      out, s_fin, s_chk, seq, H);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, float* out, float* s_fin, float* s_chk, int B, int seq, int H,
                   cudaStream_t stream) {
  if (s_chk != nullptr)
    return seq <= SHORT_SEQ ? launch_as<T, C, true, true>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream)
                            : launch_as<T, C, false, true>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream);
  return seq <= SHORT_SEQ ? launch_as<T, C, true, false>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream)
                          : launch_as<T, C, false, false>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream);
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, float* out, float* s_fin, float* s_chk, int B, int seq, int H, int C,
                     cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_fin, s_chk, B, seq, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16.  s0 may be null (zero state), and s_chk is
// null for serving.  Returns a cudaError_t (0 = launched).
static int forward(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* out, void* s_fin, void* s_chk, int B, int S, int H, int C,
                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* of = static_cast<float*>(out);
  float* ff = static_cast<float*>(s_fin);
  float* cf = static_cast<float*>(s_chk);
  if (dtype == 0) return (int)dispatch<float>(r, k, v, wf, uf, sf, of, ff, cf, B, S, H, C, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(r, k, v, wf, uf, sf, of, ff, cf, B, S, H, C, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, void* out, void* s_fin, int B, int S,
                            int H, int C, int dtype, void* stream) {
  return forward(r, k, v, w, u, s0, out, s_fin, nullptr, B, S, H, C, dtype, stream);
}

// The training form: also the state before every CK tokens into s_chk [B, H, ceil(S / CK), C, C].
extern "C" int wkv6_forward_train(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* s0, void* out, void* s_fin, void* s_chk,
                                  int B, int S, int H, int C, int dtype, void* stream) {
  if (s_chk == nullptr) return (int)cudaErrorInvalidValue;
  return forward(r, k, v, w, u, s0, out, s_fin, s_chk, B, S, H, C, dtype, stream);
}

extern "C" int wkv6_checkpoint() { return CK; }

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
