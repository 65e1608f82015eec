// RWKV-6 WKV backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// No Pallas kernel computes it: the reference differentiates the WKV recurrence with
// JAX (jax.grad through `wkv_chunked`, src/repro/models/rwkv6.py, whose function the
// Pallas kernel `wkv6_pallas` in src/repro/kernels/rwkv6_scan.py computes forward).
// Per head, with S_{t-1} the state before token t and dS_t the gradient of the state
// after it, swept from dS_T = ds_fin (or zero) down to ds0 = dS_0:
//
//     dr_t = S_{t-1} dout_t + (u o k_t)(v_t . dout_t)   dk_t = dS_t v_t + (r_t o u)(v_t . dout_t)
//     dv_t = dS_t^T k_t + (r_t . (u o k_t)) dout_t      dw_t = rowsum(dS_t o S_{t-1})
//     du   = sum_t r_t o k_t (v_t . dout_t)             dS_{t-1} = w_t o dS_t + r_t (x) dout_t
//
// dw is the gradient through the reference's log(max(w, 1e-38)), dlogw_t / w_t where
// w_t > 1e-38 and 0 elsewhere, taken here without the division: rowsum(dS_t o S_{t-1}).
//
// Chunked form.  The forward's training form (csrc/wkv6.cu) saves the state S before
// every chunk of L = CK = 16 tokens.  Within a chunk, with E the gradient of the state
// after its last token, w the decays of row i (a channel of r, k, w), and products of
// decays taken directly (no division: the model's decays come close to 0):
//
//     G_t = prod_{s < t} w_s      F_t = prod_{t < s < L} w_s      P(a, b) = prod_{a < s < b} w_s
//     S_{t-1} = G_t o S + sum_{tau < t} P(tau, t) k_tau (x) v_tau
//     dS_t    = F_t o E + sum_{sig > t} P(t, sig) r_sig (x) dout_sig
//
// so every gradient is a few products with the chunk's two C x C matrices, which need
// no sum across threads, and short sums over the chunk's tokens, row by row:
//
//     X = S dout^T, Y = E v^T (C x L); Z = (F o k)^T E (L x C); A_xy = v_x . dout_y (L x L);
//     q = rowsum(E o S); B_{sig t} = sum_i P_i(t, sig) r_sig,i k_t,i
//     dr_t = G_t X_t + H_t[t] + u k_t A_tt,    H_{t+1} = w_t H_t + k_t A_t.  (H_0 = 0)
//     dk_t = F_t Y_t + N_t[t] + r_t u A_tt,    N_{t-1} = w_t N_t + r_t A_.t  (N_{L-1} = 0)
//     dw_t = F_t G_t q + F_t J_t + G_t M_t + sum_{sig > t} P(t, sig) r_sig H_t[sig]
//            J_{t+1} = w_t J_t + k_t Y_t,      M_{t-1} = w_t M_t + r_t X_t
//     dv_t = Z_t + sum_{sig > t} B_{sig t} dout_sig + (r_t . (u o k_t)) dout_t
//     E before the chunk = G_L o E + sum_sig (G_sig o r_sig) (x) dout_sig
//
// That is the recurrence's gradient with its sums regrouped: dw is still rowsum(dS_t o
// S_{t-1}) expanded, never divided by w, and 0 where w <= 1e-38.
//
// Design.  One block of 256 threads per (batch row, head) at C >= 16 (64 at C = 8) sweeps
// the chunks last first; at C = 64 it takes 103 KB of shared memory (opted into once per
// instantiation and device) and at most 128 registers, so two blocks share an SM.  A
// chunk has these phases between block barriers:
//   1. r, k, v widened to f32 (w and dout were staged in f32 by cp.async, into one of two
//      buffers); meanwhile four lanes a row scan the row's decays into G o r, F o k, G_L.
//   2. The products on the CUDA cores, register-blocked over 4 tokens, a quarter of the
//      threads each: X and Y (4 rows a thread, 64 FMAs per 8 16-byte loads), Z (4
//      columns a thread, parked in shared memory); the fourth quarter forms A, the bonus
//      and q.  Then every thread: B (16 lanes a token, a reduce-scatter across them; the
//      terms with sig <= t skipped a warp at a time) and its own 4 x 4 patch of E before
//      the chunk (a rank-16 update, kept in registers until the barrier and then stored
//      for the next chunk).
//   3. dv (every thread 4 columns of a token, stored as whole rows), then the token
//      recurrences: four lanes a row, each carrying the quarter y0 .. y0 + 3 of the
//      16-vectors H and N (at C >= 32 the lanes of a warp share a quarter).  H_t is needed only up to
//      t = y0 + 3 and N_t only down to y0, so each quarter steps 20 of the 32 token steps.
//      A lane owns the outputs of its quarter's tokens; dw's last sum over sig > t takes
//      the later quarters' parts (a dot product each) through shared memory, across one
//      barrier between the forward and the backward pass.
//   4. dr, dk, dw, staged in shared memory, stored as whole 16-byte pieces.
// The next chunk's tile and saved state are staged with cp.async during phases 1-4.  No
// atomics: two calls are bitwise equal.
//
// Cost.  Per chunk the products are 4 C^2 L multiply-adds a head and the recurrences about
// 2 C L^2 (H and N, of which 5/8 are stepped) and C L^2 / 2 (dw's last sum), against the
// recurrence form's 7 C^2 L; no sum of the products crosses threads.  At the training
// shape below on an NVIDIA H100 80GB HBM3 at 700 W (scripts/scan_variants.py and
// chip_smoke.py, PERF.md) the kernel takes 1.41-1.44 ms, the products about 0.31 of it
// and the token recurrences about 0.29 (the wkv_bwd_no_* probes).  Measured there and
// replaced: one block a head stepping the recurrence token by token, each 4-token
// sub-chunk's old states recomputed from its chunk's saved state (2.25-2.27 ms); a
// cluster of 4 blocks a head splitting its rows, old states recomputed once into shared
// memory and dv summed over distributed shared memory (3.29); this form with X, Y, Z on
// the tensor cores in tf32, three products each for f32 accuracy (1.86).
//
// Bound.  The chunked form above is the cheapest count known: per head and chunk the four
// products 8 C^2 L f32 FLOP, E's decay and q 3 C^2, the token sums about 7.5 C L^2 and the
// per-token terms about 30 C L, some 10.5 C^2 a token at C = 64 (the recurrence form: 14 C^2).
// At bf16 B4 S2048 H64 C64 that is 0.337 ms on an H100 SXM at 67 TFLOP/s; the bytes (r, k,
// v, dr, dk, dv in bf16; w, dout, dw and the saved states in f32) take 0.402 ms, the bound
// (chip_smoke.py's wkv6_train_bounds).
//
// Inputs: r, k, v [B, S, H, C] in f32 or bf16; w [B, S, H, C], u [H, C], s_chk
// [B, H, ceil(S / CK), C, C], dout [B, S, H, C] and ds_fin [B, H, C, C] (optional) in f32.
// Outputs: dr, dk, dv [B, S, H, C] in r's dtype; dw [B, S, H, C], du_part [B, H, C] and
// ds0 [B, H, C, C] in f32.  All contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "opt_in.cuh"        // opt_in_once, MAX_DEVICES
#include "wkv6_common.cuh"  // CK

namespace {

constexpr int L = CK;            // tokens of a chunk
constexpr float W_MIN = 1e-38f;  // the reference's clamp of w before its log

template <typename T, int C>
struct Geometry {
  static constexpr int NT = C >= 16 ? 256 : 64;  // threads of a block
  static constexpr int MIN_BLOCKS = C == 64 ? 2 : 1;  // asked of ptxas: two blocks an SM at rwkv6's C = 64
  static constexpr int GRID = C >= 16 ? 16 : 8;  // threads along each side of E,
  static constexpr int PA = C / GRID;            // each holding a PA x PA patch
  static constexpr int QN = NT / 4;              // threads of each product: X, Y, Z (and A, q, the bonus)
  static constexpr int XR = 16 * C / NT;         // X, Y: rows of a thread (at 4 tokens); Z, dv: columns
  static constexpr int XS = C / XR;              // threads along the rows (columns) of one token block
  static constexpr int TG = NT / L, TR = C / TG;  // B: threads of a token, and their rows each
  static constexpr int BG = QN / L, BN = C / BG;  // the bonus: threads of a token, and their rows each
  static constexpr int SP = C + 4, XP = L + 4;   // padded rows of [.][C] and [.][L] arrays, in floats
  static constexpr int XT = (int)sizeof(T);
  // shared memory, in bytes: r, k, v as stored, S and E [C][SP], [L][SP] tiles of r, k, v, F o k,
  // G o r, Z and two chunks' w and dout (staged in f32 as stored), G_L [C] and the recurrences' terms
  // [24][C], X and Y [C][XP], A, its transpose and B [L][XP], q [C] and the bonus [L]
  static constexpr int RAW = 3 * L * C * XT;
  static constexpr int SMEM = RAW + (2 * C * SP + 10 * L * SP + 25 * C + 2 * C * XP + 3 * L * XP + C + L) * 4;
  static_assert(GRID * GRID == NT && PA * GRID == C && TG <= 32, "tiling");
  static_assert(XS * 4 == QN && XR * XS == C && XS * L == NT && TR * TG == C && L % TG == 0 && BN * BG == C, "products");
  static_assert(C % 4 == 0 && 4 * C <= NT && L == 16, "tiling");
  static_assert(RAW % 16 == 0, "staging");
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");
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

// N consecutive f32 values to p (aligned to their size).
template <int N>
__device__ __forceinline__ void store(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = float4{x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]};
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = float2{x[0], x[1]};
  } else {
    p[0] = x[0];
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 16 bytes of outputs from 16 / sizeof(T) f32 values at src.
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0], b = reinterpret_cast<const float4*>(src)[1];
  *reinterpret_cast<uint4*>(dst) = uint4{bf16_pair(a.x, a.y), bf16_pair(a.z, a.w), bf16_pair(b.x, b.y),
                                         bf16_pair(b.z, b.w)};
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read) when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// CK rows of N elements of one (batch, head) slice into dst[CK][N]; src + base + t * stride is
// row t.  Rows at or past seq are zero-filled.
template <int N, int NT, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, size_t base, size_t stride, int t0, int seq,
                                           int tid) {
  constexpr int PER = 16 / (int)sizeof(E), CH = N / PER;  // elements per chunk, chunks per row
  static_assert(CH * PER == N, "rows are whole 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (CK * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT, t = e / CH, q = e % CH;
    const bool in = t0 + t < seq;
    if (e < CK * CH)
      cp_async16(dst + t * N + q * PER, src + (in ? base + (size_t)(t0 + t) * stride + q * PER : 0), in);
  }
}

// One halving step of a reduce-scatter of partial sums across the lanes that differ in
// bit D: p[0 .. 2D) in, the lane's half p[0 .. D) summed with the partner's out (the upper
// half if lane & D).  From D = G / 2 down to 1, p[0] ends as the full sum of item lane % G.
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

// XR values of T from f32 (aligned to their size).
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&x)[N]) { store(p, x); }
template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<uint2*>(p)[q] = uint2{bf16_pair(x[4 * q], x[4 * q + 1]), bf16_pair(x[4 * q + 2], x[4 * q + 3])};
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint32_t*>(p) = bf16_pair(x[0], x[1]);
  } else {
    p[0] = __float2bfloat16(x[0]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(Geometry<T, C>::NT, Geometry<T, C>::MIN_BLOCKS) wkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s_chk,
    const float* __restrict__ dout, const float* __restrict__ ds_fin, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ ds0, int seq, int H) {
  using Gm = Geometry<T, C>;
  constexpr int NT = Gm::NT, GRID = Gm::GRID, PA = Gm::PA, QN = Gm::QN, XR = Gm::XR, XS = Gm::XS, TG = Gm::TG;
  constexpr int TR = Gm::TR, BG = Gm::BG, BN = Gm::BN;
  constexpr int SP = Gm::SP, XP = Gm::XP, XT = Gm::XT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rraw = reinterpret_cast<T*>(smem);  // [L][C] each: r, k, v as stored
  T* kraw = rraw + L * C;
  T* vraw = kraw + L * C;
  float* Ss = reinterpret_cast<float*>(smem + Gm::RAW);  // [C][SP] S, the state before the chunk
  float* Es = Ss + C * SP;                                // [C][SP] E, dS after the chunk's last token
  float* rt = Es + C * SP;                                // [L][SP] each: r, k, v in f32
  float* kt = rt + L * SP;
  float* vt = kt + L * SP;
  float* FK = vt + L * SP;      // [L][SP] F_t o k_t
  float* GR = FK + L * SP;      // [L][SP] G_t o r_t
  float* outs = vt;             // [3][L][C] dr, dk, dw, staged over v, F o k, G o r once those are read
  float* Zs = GR + L * SP;      // [L][SP] Z = (F o k)^T E
  float* wd = Zs + L * SP;      // [2][2][L][SP] w and dout of two chunks, by chunk parity
  float* GL = wd + 4 * L * SP;  // [C] G_L, the product of the chunk's decays
  float* Qf = GL + C;           // [24][C] the token recurrences' cross-quarter terms of dw
  float* Xs = Qf + 24 * C;      // [C][XP] X = S dout^T
  float* Ys = Xs + C * XP;      // [C][XP] Y = E v^T
  float* As = Ys + C * XP;      // [L][XP] A_xy = v_x . dout_y
  float* AT = As + L * XP;      // [L][XP] A transposed
  float* Bs = AT + L * XP;      // [L][XP] B_{sig t}
  float* qv = Bs + L * XP;      // [C] q = rowsum(E o S)
  float* bonus = qv + C;        // [L] r_t . (u o k_t)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid % 32;
  const size_t stride = (size_t)H * C;                           // between tokens
  const size_t base = (size_t)b * seq * stride + (size_t)h * C;  // (b, t = 0, h, 0)
  const size_t state_base = ((size_t)b * H + h) * C * C;
  const int nchunk = (seq + L - 1) / L;
  const float* chk = s_chk + state_base * nchunk;  // this head's saved states [nchunk][C][C]

  const int ea = tid / GRID * PA, eb = tid % GRID * PA;  // this thread's patch of E
  // the products: role 0 X, 1 Y (rows xs + XS a at tokens 4 tb ..), 2 Z (columns XR xs .. at tokens 4 tb ..),
  // 3 A, the bonus and q
  const int role = tid / QN, qt = tid % QN, xs = qt % XS, tb = qt / XS;
  const int ci = tid % C, cq = tid / C, y0 = 4 * cq;  // the token recurrences: row ci, quarter y0 .. of the tokens

  {
    const bool has_dsfin = ds_fin != nullptr;
#pragma unroll
    for (int a = 0; a < PA; ++a) {
      float e[PA];
      if (has_dsfin) {
        load(ds_fin + state_base + (size_t)(ea + a) * C + eb, e);
      } else {
#pragma unroll
        for (int x = 0; x < PA; ++x) e[x] = 0.f;
      }
      store(Es + (ea + a) * SP + eb, e);
    }
  }
  float du_acc = 0.f;  // du of row tid (tid < C)

  auto stage_tile = [&](int c) {  // chunk c's r, k, v as stored; rows past seq zero-filled
    const int t0 = c * L;
    stage_rows<C, NT>(rraw, r, base, stride, t0, seq, tid);
    stage_rows<C, NT>(kraw, k, base, stride, t0, seq, tid);
    stage_rows<C, NT>(vraw, v, base, stride, t0, seq, tid);
  };
  auto stage_wd = [&](int c, int q) {  // chunk c's w and dout into the padded buffers of parity q
    const int t0 = c * L;
    float* wdst = wd + (q & 1) * 2 * L * SP;
    for (int e = tid; e < 2 * L * C / 4; e += NT) {
      const int which = e / (L * C / 4), t = e / (C / 4) % L, j = e % (C / 4) * 4;
      const bool in = t0 + t < seq;
      const float* src = which == 0 ? w : dout;
      cp_async16(wdst + (which * L + t) * SP + j, src + (in ? base + (size_t)(t0 + t) * stride + j : 0), in);
    }
  };
  auto stage_state = [&](int c) {  // chunk c's saved state into Ss
    const float* src = chk + (size_t)c * C * C;
    for (int e = tid; e < C * C / 4; e += NT) {
      const int i = e / (C / 4), j = e % (C / 4) * 4;
      cp_async16(Ss + i * SP + j, src + i * C + j, true);
    }
  };

  stage_tile(nchunk - 1);
  stage_wd(nchunk - 1, 0);
  stage_state(nchunk - 1);
  cp_async_commit();
  for (int q = 0; q < nchunk; ++q) {
    const int c = nchunk - 1 - q, t0 = c * L, n = min(L, seq - t0);
    cp_async_wait_all();
    __syncthreads();  // the tiles and S have landed, E is in, and the last chunk's outputs are stored
    if (c > 0) stage_wd(c - 1, q + 1);  // into the buffers the last chunk used
    float* wt = wd + (q & 1) * 2 * L * SP;  // [L][SP] w and dout in f32
    float* dt = wt + L * SP;

    // r, k, v in f32; tokens past seq become identities (w = 1; r, k, v, dout are zero-filled).
    for (int e = 4 * tid; e < L * C; e += 4 * NT) {
      const int t = e / C, j = e % C;
      float x[4];
      load(rraw + e, x);
      store(rt + t * SP + j, x);
      load(kraw + e, x);
      store(kt + t * SP + j, x);
      load(vraw + e, x);
      store(vt + t * SP + j, x);
      if (t >= n) {
        const float one[4] = {1.f, 1.f, 1.f, 1.f};
        store(wt + t * SP + j, one);
      }
    }
    // Meanwhile the decays of each row, from r, k as stored and w (1 past seq).
    {  // G_t and F_t of row tid / 4: four tokens a lane, the segments' products scanned across the row's lanes
      const int i = tid / 4, sg = tid % 4, iv = i < C ? i : 0;
      float w4[4], g4[4], f4[4], pre = 1.f, suf = 1.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) w4[m] = 4 * sg + m < n ? wt[(4 * sg + m) * SP + iv] : 1.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) g4[m] = pre, pre *= w4[m];
#pragma unroll
      for (int m = 3; m >= 0; --m) f4[m] = suf, suf *= w4[m];
      float up = pre, down = pre;  // inclusive products of the segments below / above, this one's included
#pragma unroll
      for (int d = 1; d < 4; d *= 2) {
        const float x = __shfl_up_sync(0xffffffffu, up, d, 4), y = __shfl_down_sync(0xffffffffu, down, d, 4);
        up = sg >= d ? up * x : up;
        down = sg + d < 4 ? down * y : down;
      }
      float below = __shfl_up_sync(0xffffffffu, up, 1, 4), above = __shfl_down_sync(0xffffffffu, down, 1, 4);
      below = sg == 0 ? 1.f : below;
      above = sg == 3 ? 1.f : above;
      if (i < C) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int t = 4 * sg + m;
          const float gt = below * g4[m], ft = above * f4[m];
          float rr[1], kk[1];
          load(rraw + t * C + i, rr);
          load(kraw + t * C + i, kk);
          GR[t * SP + i] = gt * rr[0];
          FK[t * SP + i] = ft * kk[0];
        }
        if (sg == 3) GL[i] = up;
      }
    }
    __syncthreads();
    if (c > 0) stage_tile(c - 1);  // the raw tile has been read
    cp_async_commit();

    // The products, a quarter of the threads each, register-blocked over 4 tokens: X = S dout^T, Y = E v^T,
    // Z = (F o k)^T E; the fourth quarter takes A, the bonus and q.
    if (role < 2) {
      const float* mat = role == 0 ? Ss : Es;
      const float* vec = role == 0 ? dt : vt;
      float acc[XR][4];
#pragma unroll
      for (int a = 0; a < XR; ++a) {
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[a][m] = 0.f;
      }
#pragma unroll 2
      for (int j = 0; j < C; j += 4) {
        float mv[XR][4], vv[4][4];
#pragma unroll
        for (int a = 0; a < XR; ++a) load(mat + (xs + XS * a) * SP + j, mv[a]);
#pragma unroll
        for (int m = 0; m < 4; ++m) load(vec + (4 * tb + m) * SP + j, vv[m]);
#pragma unroll
        for (int a = 0; a < XR; ++a) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[a][m] = fmaf(mv[a][x], vv[m][x], acc[a][m]);
          }
        }
      }
      float* out = role == 0 ? Xs : Ys;
#pragma unroll
      for (int a = 0; a < XR; ++a) store(out + (xs + XS * a) * XP + 4 * tb, acc[a]);
    } else if (role == 2) {
      float zacc[4][XR];  // tokens 4 tb .. x columns XR xs ..
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int x = 0; x < XR; ++x) zacc[m][x] = 0.f;
      }
#pragma unroll 2
      for (int i = 0; i < C; i += 4) {
        float fk[4][4], e[4][XR];
#pragma unroll
        for (int m = 0; m < 4; ++m) load(FK + (4 * tb + m) * SP + i, fk[m]);
#pragma unroll
        for (int y = 0; y < 4; ++y) load(Es + (i + y) * SP + XR * xs, e[y]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int y = 0; y < 4; ++y) {
#pragma unroll
            for (int x = 0; x < XR; ++x) zacc[m][x] = fmaf(fk[m][y], e[y][x], zacc[m][x]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) store(Zs + (4 * tb + m) * SP + XR * xs, zacc[m]);
    } else {
      for (int e = qt; e < L * L; e += QN) {  // A_xy = v_x . dout_y, and its transpose
        const int x = e / L, y = e % L;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < C; j += 4) {
          float a4[4], b4[4];
          load(vt + x * SP + j, a4);
          load(dt + y * SP + j, b4);
#pragma unroll
          for (int m = 0; m < 4; ++m) acc = fmaf(a4[m], b4[m], acc);
        }
        As[x * XP + y] = acc;
        AT[y * XP + x] = acc;
      }
      {  // bonus_t = r_t . (u o k_t): BG threads a token, BN rows each
        const int t = qt / BG, i0 = qt % BG * BN;
        float rr[BN], kk[BN], uu[BN], acc = 0.f;
        load(rt + t * SP + i0, rr);
        load(kt + t * SP + i0, kk);
        load(u + h * C + i0, uu);
#pragma unroll
        for (int x = 0; x < BN; ++x) acc = fmaf(rr[x], uu[x] * kk[x], acc);
#pragma unroll
        for (int d = BG / 2; d >= 1; d /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, d);
        if (qt % BG == 0) bonus[t] = acc;
      }
      for (int i = qt; i < C; i += QN) {  // q = rowsum(E o S)
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < C; j += 4) {
          float a4[4], b4[4];
          load(Es + i * SP + j, a4);
          load(Ss + i * SP + j, b4);
#pragma unroll
          for (int m = 0; m < 4; ++m) acc = fmaf(a4[m], b4[m], acc);
        }
        qv[i] = acc;
      }
    }
    // Then every thread: B and E's update.
    {  // B_{sig t} = sum_i P_i(t, sig) r_sig,i k_t,i: TG threads a token, TR rows each, then across them
      constexpr int NB = L / TG;  // items a lane finishes
      const int bt = tid / TG, bl = tid % TG, bt_warp = tid / 32 * (32 / TG);  // the warp's first token
      float uu[TR], p[NB][TG];
      load(kt + bt * SP + TR * bl, uu);
#pragma unroll
      for (int sg = 0; sg < L; ++sg) {
        if (sg <= bt_warp) {  // sig <= t for every token of the warp
          p[sg / TG][sg % TG] = 0.f;
          continue;
        }
        float rr[TR], ww[TR];
        load(rt + sg * SP + TR * bl, rr);
        load(wt + sg * SP + TR * bl, ww);
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < TR; ++x) acc = fmaf(uu[x], rr[x], acc);
        const bool later = sg > bt;
        p[sg / TG][sg % TG] = later ? acc : 0.f;
#pragma unroll
        for (int x = 0; x < TR; ++x) uu[x] = later ? uu[x] * ww[x] : uu[x];
      }
#pragma unroll
      for (int q2 = 0; q2 < NB; ++q2) {
        reduce_scatter<TG / 2>(p[q2], lane);
        Bs[(q2 * TG + bl) * XP + bt] = p[q2][0];
      }
    }
    // E before the chunk: G_L o E + sum_sig (G_sig o r_sig) (x) dout_sig, in registers until E has been read
    float E[PA][PA];
    {
      float gl[PA];
      load(GL + ea, gl);
#pragma unroll
      for (int a = 0; a < PA; ++a) {
        load(Es + (ea + a) * SP + eb, E[a]);
#pragma unroll
        for (int x = 0; x < PA; ++x) E[a][x] *= gl[a];
      }
#pragma unroll
      for (int sg = 0; sg < L; ++sg) {
        float g[PA], d[PA];
        load(GR + sg * SP + ea, g);
        load(dt + sg * SP + eb, d);
#pragma unroll
        for (int a = 0; a < PA; ++a) {
#pragma unroll
          for (int x = 0; x < PA; ++x) E[a][x] = fmaf(g[a], d[x], E[a][x]);
        }
      }
    }
    __syncthreads();  // the products and E's update have read S, E, F o k and G o r
    if (c > 0) stage_state(c - 1);  // S has been read
    cp_async_commit();
#pragma unroll
    for (int a = 0; a < PA; ++a) store(Es + (ea + a) * SP + eb, E[a]);
    if (c == 0) {
#pragma unroll
      for (int a = 0; a < PA; ++a) store(ds0 + state_base + (size_t)(ea + a) * C + eb, E[a]);
    }

    if (tid < C) {  // du of row tid
#pragma unroll
      for (int t = 0; t < L; ++t) du_acc = fmaf(rt[t * SP + tid] * kt[t * SP + tid], As[t * XP + t], du_acc);
    }
    // dv_t = Z_t + sum_{sig > t} B_{sig t} dout_sig + bonus_t dout_t, as whole rows: XS threads a token, XR columns each
    {
      const int t = tid / XS, c0 = tid % XS * XR;
      float acc[XR];
      load(Zs + t * SP + c0, acc);
#pragma unroll
      for (int sg = 0; sg < L; ++sg) {
        float d[XR];
        load(dt + sg * SP + c0, d);
        const float bst = sg == t ? bonus[t] : Bs[sg * XP + t];  // B is 0 for sig <= t
#pragma unroll
        for (int x = 0; x < XR; ++x) acc[x] = fmaf(bst, d[x], acc[x]);
      }
      if (t < n) store_row(dv + base + (size_t)(t0 + t) * stride + c0, acc);
    }

    // The token recurrences, four lanes to a row, each lane one quarter y0 .. y0 + 3 of the chunk's tokens
    // (at C >= 32 the lanes of a warp share it): forward for dr and dw's first terms, backward for dk and dw.
    // The forward needs H_t only up to t = y0 + 3 and the backward N_t only down to t = y0, so a lane steps
    // the forward over t <= y0 + 3 and the backward over t >= y0: 20 steps of 32 for every quarter.  A lane
    // owns the outputs of its quarter's tokens.  G_t and F_t are formed as the passes go.
    constexpr int TP = L - 5;  // tp[t] = P(t, y0), the decays between t and the quarter: 1 from t = y0 - 1 <= L - 5 on
    auto far_slot = [](int t) { return t < 4 ? 3 * t : t < 8 ? 12 + 2 * (t - 4) : 20 + (t - 8); };  // Qf rows of t
    const float* xr = Xs + ci * XP;  // X and Y of row ci, by token
    const float* yr = Ys + ci * XP;
    float ui = 0.f, dwa[4], dwq[4], gk[4], ak[4];  // of the owned tokens: G_t q + J_t, Q_t's own part, G_t, A_tt
    if (tid < 4 * C) {
      float tp[TP];
      ui = u[h * C + ci];
      const float qi = qv[ci];
#pragma unroll
      for (int t = TP - 1; t >= 0; --t) tp[t] = t + 1 < y0 ? wt[(t + 1) * SP + ci] * (t + 1 < TP ? tp[t + 1] : 1.f) : 1.f;
      float rq[4], wq[4];  // r and w of this quarter's tokens
#pragma unroll
      for (int m = 0; m < 4; ++m) rq[m] = rt[(y0 + m) * SP + ci], wq[m] = wt[(y0 + m) * SP + ci];
      // P(y0, y0 + m) r_{y0 + m}, for tokens before this quarter (times tp); P(y0 + j, y0 + m) r_{y0 + m}, j < m,
      // for the quarter's own tokens
      const float crw[4] = {rq[0], wq[0] * rq[1], wq[0] * wq[1] * rq[2], wq[0] * wq[1] * wq[2] * rq[3]};
      const float near[3][4] = {{0.f, rq[1], wq[1] * rq[2], wq[1] * wq[2] * rq[3]},
                                {0.f, 0.f, rq[2], wq[2] * rq[3]},
                                {0.f, 0.f, 0.f, rq[3]}};
      float hh[4] = {0.f, 0.f, 0.f, 0.f}, jj = 0.f, g = 1.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        if (t <= y0 + 3) {
          const float wv = wt[t * SP + ci], kv = kt[t * SP + ci];
          float a4[4];
          load(As + t * XP + y0, a4);
          // dw's last term at t: sum over sig > t of P(t, sig) r_sig H_t[sig], this quarter's part
          if (t < y0) {  // a later quarter: all four terms, for the owner to add
            float qp = 0.f;
#pragma unroll
            for (int m = 0; m < 4; ++m) qp = fmaf(crw[m], hh[m], qp);
            Qf[(far_slot(t) + cq - t / 4 - 1) * C + ci] = qp * (t < TP ? tp[t] : 1.f);
          } else {  // t / 4 == cq: the owner
            float qn = 0.f;
#pragma unroll
            for (int m = t % 4 + 1; m < 4; ++m) qn = fmaf(near[t % 4 < 3 ? t % 4 : 0][m], hh[m], qn);
            const float att = As[t * XP + t];
            outs[t * C + ci] = g * xr[t] + hh[t % 4] + ui * kv * att;
            dwa[t % 4] = fmaf(g, qi, jj);
            dwq[t % 4] = qn;
            gk[t % 4] = g;
            ak[t % 4] = att;
          }
          jj = fmaf(wv, jj, kv * yr[t]);
#pragma unroll
          for (int m = 0; m < 4; ++m) hh[m] = fmaf(wv, hh[m], kv * a4[m]);
          g *= wv;
        }
      }
    }
    __syncthreads();  // every quarter's terms of dw are in
    if (tid < 4 * C) {
      float nn[4] = {0.f, 0.f, 0.f, 0.f}, mm = 0.f, f = 1.f;
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        if (t >= y0) {
          const float wv = wt[t * SP + ci], rv = rt[t * SP + ci];
          float ac[4];
          load(AT + t * XP + y0, ac);  // A_{x t} for this quarter's x
          if (t / 4 == cq) {
            float q = dwq[t % 4];
#pragma unroll
            for (int j = 0; j < 3 - t / 4; ++j) q += Qf[(far_slot(t) + j) * C + ci];
            outs[(L + t) * C + ci] = f * yr[t] + nn[t % 4] + rv * ui * ak[t % 4];
            const float dwv = fmaf(gk[t % 4], mm, fmaf(f, dwa[t % 4], q));
            outs[(2 * L + t) * C + ci] = wv > W_MIN ? dwv : 0.f;
          }
          mm = fmaf(wv, mm, rv * xr[t]);
#pragma unroll
          for (int m = 0; m < 4; ++m) nn[m] = fmaf(wv, nn[m], rv * ac[m]);
          f *= wv;
        }
      }
    }
    __syncthreads();  // dr, dk, dw are staged

    // dr, dk (in T) and dw (f32) of the chunk's tokens as whole 16-byte pieces
    {
      constexpr int PX = 16 / XT, NPX = C / PX, NPW = C / 4, NP = 2 * NPX + NPW;  // pieces a token
      for (int e = tid; e < L * NP; e += NT) {
        const int t = e / NP, f = e % NP;
        if (t < n) {
          const size_t o = base + (size_t)(t0 + t) * stride;
          if (f < 2 * NPX) {
            const int which = f / NPX, piece = f % NPX;
            store16((which == 0 ? dr : dk) + o + piece * PX, outs + (which * L + t) * C + piece * PX);
          } else {
            const int piece = f - 2 * NPX;
            store16(dw + o + piece * 4, outs + (2 * L + t) * C + piece * 4);
          }
        }
      }
    }
  }

  if (tid < C) du_part[((size_t)b * H + h) * C + tid] = du_acc;
}

template <typename T, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s_chk, const float* dout, const float* ds_fin, void* dr, void* dk, void* dv,
                   float* dw, float* du_part, float* ds0, int B, int seq, int H, cudaStream_t stream) {
  using Gm = Geometry<T, C>;
  static bool done[MAX_DEVICES] = {};  // one flag per instantiation and device
  cudaError_t err = opt_in_once(wkv6_bwd_kernel<T, C>, Gm::SMEM, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  wkv6_bwd_kernel<T, C><<<grid, Gm::NT, Gm::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s_chk, dout, ds_fin,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, ds0, seq, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s_chk, const float* dout, const float* ds_fin, void* dr, void* dk, void* dv,
                     float* dw, float* du_part, float* ds0, int B, int seq, int H, int C, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(r, k, v, w, u, s_chk, dout, ds_fin, dr, dk, dv, dw, du_part, ds0, B, seq, H, stream);
    case 16: return launch<T, 16>(r, k, v, w, u, s_chk, dout, ds_fin, dr, dk, dv, dw, du_part, ds0, B, seq, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s_chk, dout, ds_fin, dr, dk, dv, dw, du_part, ds0, B, seq, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s_chk, dout, ds_fin, dr, dk, dv, dw, du_part, ds0, B, seq, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v (and dr, dk, dv): 0 = float32, 1 = bfloat16.  ds_fin may be null (zero).
// Returns a cudaError_t (0 = launched).
extern "C" int wkv6_backward(const void* r, const void* k, const void* v, const void* w, const void* u,
                             const void* s_chk, const void* dout, const void* ds_fin, void* dr, void* dk,
                             void* dv, void* dw, void* du_part, void* ds0, int B, int S, int H, int C, int dtype,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(s_chk);
  const float* df = static_cast<const float*>(dout);
  const float* ff = static_cast<const float*>(ds_fin);
  float* dwf = static_cast<float*>(dw);
  float* duf = static_cast<float*>(du_part);
  float* d0f = static_cast<float*>(ds0);
  if (dtype == 0)
    return (int)dispatch<float>(r, k, v, wf, uf, cf, df, ff, dr, dk, dv, dwf, duf, d0f, B, S, H, C, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(r, k, v, wf, uf, cf, df, ff, dr, dk, dv, dwf, duf, d0f, B, S, H, C, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
