// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// The gradient of the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:126), which is forward-only: the
// reference trains through JAX's autodiff of its blocked jnp twin
// (src/repro/models/attention.py:80-163).  The port's forward is a CUDA kernel
// (flash_attention.cu), so its gradient is these kernels.  Same function as that
// autodiff: for s = scale·q·kᵀ, t = tanh(s/cap), the logit cap·t (s itself with
// no cap), p = exp(logit - lse) under the causal / sliding-window mask (p = 0
// outside it) and o = p·v,
//
//   dv = pᵀ·do,   dp = do·vᵀ,   ds = p∘(dp - D)∘(1 - t²),   D = rowsum(do∘o),
//   dq = scale·ds·k,   dk = scale·dsᵀ·q,
//
// with (1 - t²) = 1 when there is no cap, and dk, dv summed over the G query
// heads that share a KV head (GQA).  lse is the forward's f32 [B, H, S]
// log-sum-exp (natural log).  q_offset is 0: training attends a sequence to
// itself.
//
// Structure (FlashAttention-2's two passes: no atomics, so two calls give
// bitwise-equal gradients), three kernels:
//
// (a) fa_bwd_rowdot: D[b, h, i] = Σ_d do·o in f32, one warp per row.
// (b) fa_bwd_dkdv: one block per (key tile, KV head, batch row).  It walks the
//     G query heads of its group and, for each, the query tiles that can see
//     its keys, recomputing s, t and p there, and keeps dk and dv for its keys
//     in registers (f32) until the end.
// (c) fa_bwd_dq:   one block per (query tile, head, batch row), walking the key
//     tiles its queries can see and keeping dq in registers.
// Tiles that the mask empties are never visited, exactly as the forward skips
// them: causal (a key tile sees queries from its first key on) and the window
// (key j is seen by queries i < j + window).  Rows past S and keys past T are
// zeros and masked out.
//
// Bound.  gemma2's training shape, bf16 B4 S=T=2048 H8 Kv4 hd256, causal:
// 67.1 M live (query, key) pairs, and the function needs five products of
// 2·hd FLOP each per pair (s, dp, dv, dk, dq): 172 GFLOP against 101 MB of
// I/O, so the bound is operations, 0.174 ms at 989 TFLOP/s.
//
// bf16 (namespace tc): `wgmma` on TMA-fed tiles, 64 x 64 tiles, two
// warpgroups per block.  What held the earlier `mma.sync` design back (2.5 ms
// at the training shape, 14x the bound), and what this one does about each:
//
// 1. Warp tiles too small for the tensor cores: 16 x 16 pieces of s and dp
//    per warp, about 4 MACs per shared-memory byte.  Here every product is a
//    warpgroup `wgmma` of 64 rows.  s and dp are m64n64k16 over the head dim
//    with both operands K-major in shared memory; the second products are
//    m64nNk16 with N the whole head dim.
// 2. Every warp re-read the whole p and ds tiles with `ldmatrix`.  Here p and
//    ds never go to shared memory as matrices: the score accumulators become
//    the A operand of the second products in the registers that hold them (the
//    forward's P·V form), and q, do and k are read MN-major through the
//    descriptor's transpose bit, so no transposed copy exists either.
// 3. Redundant arithmetic.  s and dp are still computed in both (b) and (c),
//    7 products where 5 are needed: FlashAttention-3's one-pass form, dq summed
//    through f32 atomics into a workspace, would save two but give up
//    determinism and take a 67 MB f32 workspace at the training shape.  The two
//    warpgroups split the rest without overlap.  In (b) warpgroup 0 computes
//    sᵀ = k·qᵀ (keys x queries), forms pᵀ and pᵀ∘(1 - t²), hands the latter to
//    warpgroup 1 and accumulates dv += pᵀ·do; warpgroup 1 computes dpᵀ = v·doᵀ,
//    forms dsᵀ and accumulates dk += dsᵀ·q.  In (c) warpgroup 0 computes
//    s = q·kᵀ and hands p∘(1 - t²) over; warpgroup 1 computes dp = do·vᵀ, forms
//    ds and accumulates dq += ds·k.  Warpgroup 0 then goes on to the next
//    tile, so its transcendentals overlap warpgroup 1's products (handing ds
//    back for each group to take half of dq kept the two in lockstep, with the
//    tensor cores idle while warpgroup 0 computed p).  A tile is handed over
//    in f32 through shared memory in fragment order: a thread reads back what
//    the same thread of the other warpgroup wrote, whose layout is the same.
// 4. Little latency hiding: three __syncthreads per tile and synchronous
//    waits for each copy.  Here TMA loads the streamed tiles (q and do in (b),
//    k and v in (c); the rows' lse and D in (b) by cp.async, which arrives on
//    the same barrier) into a 2-stage ring guarded by mbarriers (full: the
//    bytes landed; empty: all 8 warps are done), so the next tile's copies
//    overlap this tile's products.  As in the forward, the last warp to leave
//    a stage refills it.  A separate producer warpgroup (FlashAttention-3's
//    form, 384 threads) makes ptxas cap every thread at 168 registers (the
//    register file is split between the SM's four sub-partitions: 16,384 /
//    (3 warps x 32) rounded down to 8), and setmaxnreg (24 for the producer,
//    240 for the consumers) does not lift that cap at compile time: dkdv at
//    hd 256 then spills 1,660 bytes and takes twice as long
//    (scripts/flash_variants.py, bwd_dkdv_producer_setmaxnreg).  The two
//    warpgroups meet at two named barriers per tile, never at __syncthreads.
//
// p and ds go into the second products as two bf16 parts, hi = bf16(x) and
// lo = bf16(x - hi), into one accumulator (as the forward's P·V does; P_LO and
// DS_LO below): bf16 alone gives each weight a relative error up to 2^-9, and
// keys (dv, dk) and queries (dq) whose gradient is a sum of few large terms
// then fall outside the bf16 gate (scripts/flash_variants.py measures each).
// The scores' functions: tanh(x) = 1 - 2 / (1 + 2^(2x·log2 e)) and 2^x from
// ex2.approx, |error| ~1e-7; tanh.approx's 2^-11 relative error would move a
// logit capped at 50 by up to 0.025.  Tiles are the forward's: 64-column boxes
// of 128 bytes a row in the 128-byte swizzle, one tensor map per operand, rows
// past S or T read as zeros.  The wrapper zero-pads hd to a multiple of 64.
// The mbarrier, TMA and `wgmma` helpers and the tensor maps are hopper.cuh's,
// shared with the forward.
// Shared memory at hd 256: 215,088 bytes (dkdv) and 214,064 (dq), opted into
// once per instantiation and device, never per launch.
//
// f32: scalar FMAs on 16-query x 16-key tiles, one score per thread.  TF32
// would miss the reference's 2e-5 f32 gate; f32 runs only in the card-vs-CPU
// checks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "opt_in.cuh"  // opt_in_once, MAX_DEVICES

namespace {

constexpr int MAX_HD = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Whether query i sees key j (q_offset = 0): the forward's mask, plus rows past
// S and keys past T, which exist only as zero padding of a tile.
__device__ __forceinline__ bool live(int i, int j, int S, int T_len, int causal, int window) {
  bool ok = i < S && j < T_len;
  if (causal) ok = ok && j <= i;
  if (window > 0) ok = ok && j > i - window;
  return ok;
}

// p and ds of one score from its raw dot product s_raw = q·k and dp = do·v.
__device__ __forceinline__ void prob_and_ds(float s_raw, float dp, float lse_i, float d_i, float scale,
                                            float cap, bool ok, float& p, float& ds) {
  const float x = s_raw * scale;
  float logit = x, dcap = 1.f;
  if (cap > 0.f) {
    const float t = tanhf(x / cap);
    logit = cap * t;
    dcap = 1.f - t * t;
  }
  p = ok ? expf(logit - lse_i) : 0.f;
  ds = p * (dp - d_i) * dcap;
}

// The query tiles [qt_lo, qt_hi) of height bq that see a key in [k0, k0 + bk).
__device__ __forceinline__ void query_tiles(int k0, int bk, int bq, int S, int T_len, int causal, int window,
                                            int& qt_lo, int& qt_hi) {
  const int k_last = min(T_len, k0 + bk) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k_last + window) : S;   // key j is seen by i < j + window
  qt_lo = i_lo / bq;
  qt_hi = i_hi > i_lo ? (i_hi + bq - 1) / bq : qt_lo;
}

// The key tiles [kt_lo, kt_hi) of width bk that a query in [q0, q0 + bq) sees.
__device__ __forceinline__ void key_tiles(int q0, int bq, int bk, int S, int T_len, int causal, int window,
                                          int& kt_lo, int& kt_hi) {
  const int q_last = min(S, q0 + bq) - 1;
  const int j_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j_hi = causal ? min(T_len, q_last + 1) : T_len;
  kt_lo = j_lo / bk;
  kt_hi = j_hi > j_lo ? (j_hi + bk - 1) / bk : kt_lo;
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(do∘o), f32 [B, H, S]
// ---------------------------------------------------------------------------

constexpr int DOT_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DOT_THREADS)
fa_bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D, int B, int S, int H,
           int hd) {
  const int64_t row = (int64_t)blockIdx.x * (DOT_THREADS / 32) + threadIdx.x / 32;   // [B, S, H] order
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * S * H) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bs = row / H;   // b·S + i
    const int i = (int)(bs % S);
    const int b = (int)(bs / S);
    D[((int64_t)b * H + h) * S + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs, 16-query x 16-key tiles, one score per thread
// ---------------------------------------------------------------------------

namespace scalar {

constexpr int BQ = 16;
constexpr int BK = 16;
constexpr int NTHREADS = 256;   // = BQ · BK: thread (i, j) = (tid / BK, tid % BK) owns one score

// Shared floats: four [16][hd + 1] tiles (the +1 keeps the 16 rows a warp reads
// in 16 banks), one or two [16][hd] accumulators, p and ds or ds, lse and D.
__host__ __device__ constexpr int smem_dkdv(int hd) { return 4 * (4 * 16 * (hd + 1) + 2 * 16 * hd + 2 * 256 + 2 * 16); }
__host__ __device__ constexpr int smem_dq(int hd) { return 4 * (4 * 16 * (hd + 1) + 16 * hd + 256 + 2 * 16); }

__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride, int valid, int hd) {
  const int ld = hd + 1;
  for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) {
    const int r = idx / hd, d = idx - r * hd;
    dst[r * ld + d] = r < valid ? src[r * stride + d] : 0.f;
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* src, int valid) {
  if (threadIdx.x < 16) dst[threadIdx.x] = threadIdx.x < valid ? src[threadIdx.x] : 0.f;
}

// s = q_i·k_j and dp = do_i·v_j of this thread's score, from [16][hd + 1] tiles.
__device__ __forceinline__ void dot2(const float* Qs, const float* dOs, const float* Ks, const float* Vs, int i,
                                     int j, int hd, float& s, float& dp) {
  const int ld = hd + 1;
  s = 0.f;
  dp = 0.f;
  for (int d = 0; d < hd; ++d) {
    s = fmaf(Qs[i * ld + d], Ks[j * ld + d], s);
    dp = fmaf(dOs[i * ld + d], Vs[j * ld + d], dp);
  }
}

__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dkdv_scalar(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int T_len, int H, int Kv, int hd,
                   int causal, int window, float cap, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Ks = smem;
  float* Vs = Ks + 16 * ld;
  float* Qs = Vs + 16 * ld;
  float* dOs = Qs + 16 * ld;
  float* dKs = dOs + 16 * ld;     // [16][hd]
  float* dVs = dKs + 16 * hd;
  float* Ps = dVs + 16 * hd;      // [16][16]
  float* dSs = Ps + 256;
  float* lse_s = dSs + 256;
  float* D_s = lse_s + 16;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Kv;
  const int i_loc = threadIdx.x / BK, j_loc = threadIdx.x % BK;
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)Kv * hd;
  const int k_rows = min(BK, T_len - k0);

  load_rows(Ks, k + ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * hd, kv_stride, k_rows, hd);
  load_rows(Vs, v + ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * hd, kv_stride, k_rows, hd);
  for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) dKs[idx] = dVs[idx] = 0.f;

  int qt_lo, qt_hi;
  query_tiles(k0, BK, BQ, S, T_len, causal, window, qt_lo, qt_hi);
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      const int q_rows = min(BQ, S - q0);
      __syncthreads();   // the previous tile is consumed
      load_rows(Qs, q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd, q_stride, q_rows, hd);
      load_rows(dOs, dout + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd, q_stride, q_rows, hd);
      load_vec(lse_s, lse + ((int64_t)b * H + h) * S + q0, q_rows);
      load_vec(D_s, D + ((int64_t)b * H + h) * S + q0, q_rows);
      __syncthreads();
      float s, dp, p, ds;
      dot2(Qs, dOs, Ks, Vs, i_loc, j_loc, hd, s, dp);
      prob_and_ds(s, dp, lse_s[i_loc], D_s[i_loc], scale, cap,
                  live(q0 + i_loc, k0 + j_loc, S, T_len, causal, window), p, ds);
      Ps[i_loc * 16 + j_loc] = p;
      dSs[i_loc * 16 + j_loc] = ds;
      __syncthreads();
      for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) {   // key j, column d
        const int j = idx / hd, d = idx - j * hd;
        float av = dVs[idx], ak = dKs[idx];
#pragma unroll 4
        for (int i = 0; i < BQ; ++i) {
          av = fmaf(Ps[i * 16 + j], dOs[i * ld + d], av);
          ak = fmaf(dSs[i * 16 + j], Qs[i * ld + d], ak);
        }
        dVs[idx] = av;
        dKs[idx] = ak;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) {
    const int j = idx / hd, d = idx - j * hd;
    if (j >= k_rows) continue;
    const int64_t off = ((int64_t)b * T_len + k0 + j) * kv_stride + (int64_t)kvh * hd + d;
    dk[off] = scale * dKs[idx];
    dv[off] = dVs[idx];
  }
}

__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dq_scalar(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
                 float* __restrict__ dq, int S, int T_len, int H, int Kv, int hd, int causal, int window,
                 float cap, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;
  float* dOs = Qs + 16 * ld;
  float* Ks = dOs + 16 * ld;
  float* Vs = Ks + 16 * ld;
  float* dQs = Vs + 16 * ld;      // [16][hd]
  float* dSs = dQs + 16 * hd;     // [16][16]
  float* lse_s = dSs + 256;
  float* D_s = lse_s + 16;

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - (int)blockIdx.x;   // heaviest first: the last queries see the most keys
  const int q0 = qt * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int i_loc = threadIdx.x / BK, j_loc = threadIdx.x % BK;
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)Kv * hd;
  const int q_rows = min(BQ, S - q0);

  load_rows(Qs, q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd, q_stride, q_rows, hd);
  load_rows(dOs, dout + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd, q_stride, q_rows, hd);
  load_vec(lse_s, lse + ((int64_t)b * H + h) * S + q0, q_rows);
  load_vec(D_s, D + ((int64_t)b * H + h) * S + q0, q_rows);
  for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) dQs[idx] = 0.f;

  int kt_lo, kt_hi;
  key_tiles(q0, BQ, BK, S, T_len, causal, window, kt_lo, kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    const int k_rows = min(BK, T_len - k0);
    __syncthreads();
    load_rows(Ks, k + ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * hd, kv_stride, k_rows, hd);
    load_rows(Vs, v + ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * hd, kv_stride, k_rows, hd);
    __syncthreads();
    float s, dp, p, ds;
    dot2(Qs, dOs, Ks, Vs, i_loc, j_loc, hd, s, dp);
    prob_and_ds(s, dp, lse_s[i_loc], D_s[i_loc], scale, cap,
                live(q0 + i_loc, k0 + j_loc, S, T_len, causal, window), p, ds);
    dSs[i_loc * 16 + j_loc] = ds;
    __syncthreads();
    for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) {   // query i, column d
      const int i = idx / hd, d = idx - i * hd;
      float acc = dQs[idx];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) acc = fmaf(dSs[i * 16 + j], Ks[j * ld + d], acc);
      dQs[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 16 * hd; idx += NTHREADS) {
    const int i = idx / hd, d = idx - i * hd;
    if (i < q_rows) dq[((int64_t)b * S + q0 + i) * q_stride + (int64_t)h * hd + d] = scale * dQs[idx];
  }
}

}  // namespace scalar

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 64;                     // queries per tile
constexpr int BK = 64;                     // keys per tile
constexpr int STAGES = 2;                  // ring depth of the streamed tiles
constexpr int NTHREADS = 256;              // two warpgroups
constexpr int NWARPS = NTHREADS / 32;
constexpr int BOX_BYTES = 64 * ROW_BYTES;  // one box of a 64-row tile
constexpr int XCHG_FLOATS = 64 * 64;       // a 64 x 64 f32 tile handed between the warpgroups
constexpr int BAR_HANDED = 1;              // named barriers (0 is __syncthreads'): warpgroup 0 handed a tile over,
constexpr int BAR_TAKEN = 2;               // and warpgroup 1 took it (its buffer is free again)
constexpr float LOG2E = 1.4426950408889634f;
// The second products take p (dv) and ds (dk, dq) as bf16 hi + lo parts; false drops the lo part.
constexpr bool P_LO = true;
constexpr bool DS_LO = true;

// NC = 64-column boxes per row (the head dim padded to a multiple of 64).
__host__ __device__ constexpr int tile_bytes(int nc) { return nc * BOX_BYTES; }
// mbarriers: the tiles loaded once, then full and empty per stage; a release counter per stage
__host__ __device__ constexpr int barrier_bytes() { return 8 * (1 + 2 * STAGES) + 4 * STAGES; }
// dkdv: K and V once, Q and dO per stage, the handed tile, lse and D per stage
__host__ __device__ constexpr int smem_dkdv(int nc) {
  return ALIGN + (2 + 2 * STAGES) * tile_bytes(nc) + 4 * XCHG_FLOATS + 2 * STAGES * BQ * 4 + barrier_bytes();
}
// dq: Q and dO once, K and V per stage, the handed tile
__host__ __device__ constexpr int smem_dq(int nc) {
  return ALIGN + (2 + 2 * STAGES) * tile_bytes(nc) + 4 * XCHG_FLOATS + barrier_bytes();
}

// The NC boxes of the 64-row tile at `row` of one head into dst, on barrier bar.
template <int NC>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int head, int row,
                                         int batch) {
#pragma unroll
  for (int c = 0; c < NC; ++c) tma_load(dst + c * BOX_BYTES, map, bar, c * BOX, head, row, batch);
}

// 4 bytes global -> shared, asynchronously; zero when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrives on the barrier once this thread's earlier cp.async copies have landed (counted in its
// expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// Named barriers of the two warpgroups: bar_arrive signals, bar_sync signals and waits.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(NTHREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(NTHREADS) : "memory");
}

// After a warp is done with stage st: it arrives on the stage's empty barrier, and the last of the
// warps to do so, which alone returns true, waits for that barrier (already complete) and then
// refills the stage.  Every lane returns the same answer.
__device__ __forceinline__ bool leave_stage(uint32_t empty, uint32_t* released, int st, uint32_t parity, int lane) {
  __syncwarp();
  uint32_t last = 0;
  if (lane == 0) {
    mbar_arrive(empty + 8 * st);
    last = atomicAdd(&released[st], 1u) % NWARPS == NWARPS - 1;
  }
  last = __shfl_sync(FULL, last, 0);
  if (last) mbar_wait(empty + 8 * st, parity);
  return last;
}

// tanh(x) = 1 - 2 / (1 + 2^(2x log2 e)), |error| ~1e-7; ±1 where 2^(...) over- or underflows.
__device__ __forceinline__ float tanh_fast(float x) { return 1.f - __fdividef(2.f, 1.f + ex2(x * (2.f * LOG2E))); }

// p = 2^(logit·log2 e - lse2) of one raw score s_raw = q·k (lse2 = lse·log2 e), and pd = p·(1 - t²),
// the softcap's derivative folded in (pd = p with no cap).  pre = scale / cap (scale·log2 e with no
// cap), post = cap·log2 e.
template <bool CAP>
__device__ __forceinline__ void prob(float s_raw, float lse2, float pre, float post, float& p, float& pd) {
  if (CAP) {
    const float t = tanh_fast(s_raw * pre);
    p = ex2(post * t - lse2);
    pd = p * (1.f - t * t);
  } else {
    p = ex2(s_raw * pre - lse2);
    pd = p;
  }
}

// ds = p(1 - t²)·(dp - D)
__device__ __forceinline__ float ds_of(float pd, float dp, float d) { return pd * (dp - d); }

// Accumulator layout of a warpgroup's 64 x N tile: element 4j + e of thread t (lane t % 32) sits in
// row 16 (t / 32) + lane / 4 + 8 ((e / 2) % 2), column 8j + 2 (lane % 4) + e % 2.

// acc (64 x 64, f32) = A·Bᵀ over the head dim: the rows of one 64-row tile of NC boxes against
// those of another, both K-major; a k-step is 32 bytes into a 128-byte row.
template <int NC>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a_tile, uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss<64>(acc, sw128_desc(a_tile + off, 16, 8 * ROW_BYTES), sw128_desc(b_tile + off, 16, 8 * ROW_BYTES),
                 kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// The 32 accumulator values of a 64 x 64 tile as the bf16 A fragments of its 4 k-steps of 16
// columns, hi and lo parts: columns 16 kb .. 16 kb + 15 are elements 8 kb .. 8 kb + 7.
__device__ __forceinline__ void to_fragments(const float (&x)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_bf16(x[8 * kb + 2 * r], x[8 * kb + 2 * r + 1], hi[kb][r], lo[kb][r]);
}

// acc (64 x 64 NB, f32) += X·B: X the 64 x 64 tile whose A fragments are hi (+ lo, with LO), B the
// 64 rows of NB boxes of a tile from b_tile on, MN-major (the descriptor's transpose bit).
template <int NB, bool LO>
__device__ __forceinline__ void accumulate(float (&acc)[32 * NB], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t desc = sw128_desc(b_tile + kb * 16 * ROW_BYTES, BOX_BYTES, 8 * ROW_BYTES);
    wgmma_rs<64 * NB>(acc, hi[kb], desc);
    if (LO) wgmma_rs<64 * NB>(acc, lo[kb], desc);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// A warpgroup's 64 x 64 f32 tile to (from) shared memory in fragment order: thread t's
// elements 4g .. 4g + 3 at float4 g·128 + t, so a warp's stores and loads are contiguous.
__device__ __forceinline__ void put(float* buf, int t, const float (&x)[32]) {
  float4* b4 = reinterpret_cast<float4*>(buf);
#pragma unroll
  for (int g = 0; g < 8; ++g) b4[g * 128 + t] = make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]);
}

__device__ __forceinline__ void get(const float* buf, int t, float (&x)[32]) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 v = b4[g * 128 + t];
    x[4 * g] = v.x;
    x[4 * g + 1] = v.y;
    x[4 * g + 2] = v.z;
    x[4 * g + 3] = v.w;
  }
}

// Whether every (query, key) of the tile at (q0, k0) is live, so that no mask test is needed.
__device__ __forceinline__ bool interior(int q0, int k0, int S, int T_len, int causal, int window) {
  return q0 + BQ <= S && k0 + BK <= T_len && (!causal || k0 + BK - 1 <= q0) &&
         (window <= 0 || k0 > q0 + BQ - 1 - window);
}

// The softcap (CAP) and the mask test (MASK, for a tile that is not interior) are compile-time
// choices of the two loops below, so that the 32 elements' chains have no branch between them and
// interleave (scripts/flash_variants.py puts dq's runtime tests back: bwd_probe_dq_tests_per_element).
// with_flags picks the instantiation once per tile: f(Flag<cap>, Flag<mask>).
template <bool V>
struct Flag {};

template <typename F>
__device__ __forceinline__ void with_flags(bool cap, bool mask, F&& f) {
  if (cap) {
    if (mask) f(Flag<true>{}, Flag<true>{});
    else f(Flag<true>{}, Flag<false>{});
  } else {
    if (mask) f(Flag<false>{}, Flag<true>{});
    else f(Flag<false>{}, Flag<false>{});
  }
}

// Warpgroup 0 of (b): the raw scores sᵀ of a tile (rows keys k0 + r0 .., columns queries q0 + c0 ..)
// into pᵀ in x and pᵀ(1 - t²) in pd; lse_t holds the tile's query rows' lse.
template <bool CAP, bool MASK>
__device__ __forceinline__ void probs_by_key(Flag<CAP>, Flag<MASK>, float (&x)[32], float (&pd)[32],
                                             const float* lse_t, float pre, float post, int q0, int k0, int r0,
                                             int c0, int S, int T_len, int causal, int window) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = 8 * (e / 4) + c0 + e % 2, j = r0 + 8 * ((e / 2) % 2);
    float p;
    prob<CAP>(x[e], lse_t[i] * LOG2E, pre, post, p, pd[e]);
    if (MASK && !live(q0 + i, k0 + j, S, T_len, causal, window)) p = pd[e] = 0.f;
    x[e] = p;
  }
}

// Warpgroup 0 of (c): the raw scores s of a tile (rows queries q0 + r0 .., columns keys k0 + c0 ..)
// into p(1 - t²) in x; lse2 holds rows r0 and r0 + 8's lse·log2 e.
template <bool CAP, bool MASK>
__device__ __forceinline__ void probs_by_query(Flag<CAP>, Flag<MASK>, float (&x)[32], const float (&lse2)[2],
                                               float pre, float post, int q0, int k0, int r0, int c0, int S,
                                               int T_len, int causal, int window) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = r0 + 8 * ((e / 2) % 2), j = 8 * (e / 4) + c0 + e % 2;
    float p, pd;
    prob<CAP>(x[e], lse2[(e / 2) % 2], pre, post, p, pd);
    x[e] = !MASK || live(q0 + i, k0 + j, S, T_len, causal, window) ? pd : 0.f;
  }
}

// Rows r0 and r0 + 8 of a warpgroup's 64 x 64 NB accumulator, times mult, as bf16 into the rows of
// `out` (stride elements apart, columns 8j + c0 and + 1); rows at or past `valid` are skipped.
template <int NB>
__device__ __forceinline__ void store_rows(const float (&acc)[32 * NB], float mult, __nv_bfloat16* out,
                                           int64_t stride, int r0, int c0, int valid) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + r * stride + 8 * j + c0) =
          __floats2bfloat162_rn(mult * acc[4 * j + 2 * half], mult * acc[4 * j + 2 * half + 1]);
  }
}

// (b) dk and dv of one 64-key tile of one KV head: warpgroup 0 forms pᵀ and accumulates dv,
// warpgroup 1 forms dsᵀ and accumulates dk, each over the whole head dim.  Warp 0 starts the
// ring; after that the last warp to leave a stage refills it with the item STAGES ahead.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_dkdv_tc(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
               const float* __restrict__ lse, const float* __restrict__ D, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int S, int T_len, int H, int Kv, int causal, int window,
               float cap, float scale, int n_kt) {
  constexpr int HD = NC * BOX;
  constexpr int TILE = tile_bytes(NC);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + TILE;
  const uint32_t q_s = v_s + TILE;                  // stage st at q_s + st TILE
  const uint32_t do_s = q_s + STAGES * TILE;
  float* handed = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * TILE);   // pᵀ(1 - t²)
  float* lse_s = handed + XCHG_FLOATS;              // [STAGES][BQ]
  float* D_s = lse_s + STAGES * BQ;                 // [STAGES][BQ]
  const uint32_t kv_full = smem_addr(D_s + STAGES * BQ);
  const uint32_t full = kv_full + 8;                // then empty: one of each per stage
  const uint32_t empty = full + 8 * STAGES;
  uint32_t* released = reinterpret_cast<uint32_t*>(D_s + STAGES * BQ) + 2 * (1 + 2 * STAGES);   // per stage

  const int heads = gridDim.x / n_kt;               // Kv·B; the heaviest key tiles (the first) come first
  const int kt = (int)blockIdx.x / heads;
  const int kvh = (int)blockIdx.x % heads % Kv;
  const int b = (int)blockIdx.x % heads / Kv;
  const int k0 = kt * BK;
  const int group = H / Kv;
  int qt_lo, qt_hi;
  query_tiles(k0, BK, BQ, S, T_len, causal, window, qt_lo, qt_hi);
  const int nq = qt_hi - qt_lo;
  const int n_items = group * nq;                   // (query head of the group, query tile)

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // Item it into its stage, by a whole warp: lane 0 starts the TMA copies of Q and dO, and every lane
  // copies its rows of lse and D and arrives once they have landed.
  auto load_item = [&](int it) {
    const int st = it % STAGES;
    const int h = kvh * group + it / nq;
    const int q0 = (qt_lo + it % nq) * BQ;
    const uint32_t bar = full + 8 * st;
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * TILE);
      tma_tile<NC>(q_s + st * TILE, &q_map, bar, h, q0, b);
      tma_tile<NC>(do_s + st * TILE, &do_map, bar, h, q0, b);
    }
    const int64_t row = ((int64_t)b * H + h) * S + q0;
    for (int r = lane; r < BQ; r += 32) {
      const bool ok = q0 + r < S;
      cp_async4(smem_addr(lse_s + st * BQ + r), lse + (ok ? row + r : 0), ok);
      cp_async4(smem_addr(D_s + st * BQ + r), D + (ok ? row + r : 0), ok);
    }
    cp_async_arrive(bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 32);                 // the loading warp's lanes, once their lse / D landed
      mbar_init(empty + 8 * st, NWARPS);            // one arrival per warp
      released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32 && n_items > 0) {
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * TILE);
      tma_tile<NC>(k_s, &k_map, kv_full, kvh, k0, b);
      tma_tile<NC>(v_s, &v_map, kv_full, kvh, k0, b);
    }
    for (int it = 0; it < STAGES && it < n_items; ++it) load_item(it);
  }

  {
    const int t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + lane / 4;        // accumulator rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);                  // and columns 8j + c0, + 1
    const bool use_cap = cap > 0.f;
    const float pre = use_cap ? scale / cap : scale * LOG2E;
    const float post = cap * LOG2E;
    float acc[HD / 2];                              // dv (warpgroup 0) or dk (1): rows keys, columns hd
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    if (n_items > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % STAGES;
      const int q0 = (qt_lo + it % nq) * BQ;
      const uint32_t qt_s = q_s + st * TILE, dot_s = do_s + st * TILE;
      const bool inner = interior(q0, k0, S, T_len, causal, window);
      float x[32], y[32];
      uint32_t hi[4][4], lo[4][4];
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      if (wg == 0) {
        scores<NC>(x, k_s, qt_s);                   // sᵀ = k·qᵀ: rows keys, columns queries
        const float* lse_t = lse_s + st * BQ;
        with_flags(use_cap, !inner, [&](auto cap_f, auto mask_f) {
          probs_by_key(cap_f, mask_f, x, y, lse_t, pre, post, q0, k0, r0, c0, S, T_len, causal, window);
        });
        if (it > 0) bar_sync(BAR_TAKEN);             // warpgroup 1 took the previous tile
        put(handed, t, y);
        bar_arrive(BAR_HANDED);
        to_fragments(x, hi, lo);
        accumulate<NC, P_LO>(acc, hi, lo, dot_s);   // dv += pᵀ·do
      } else {
        scores<NC>(x, v_s, dot_s);                  // dpᵀ = v·doᵀ
        const float* D_t = D_s + st * BQ;
        bar_sync(BAR_HANDED);
        get(handed, t, y);
        if (it + 1 < n_items) bar_arrive(BAR_TAKEN);
#pragma unroll
        for (int e = 0; e < 32; ++e) x[e] = ds_of(y[e], x[e], D_t[8 * (e / 4) + c0 + e % 2]);
        to_fragments(x, hi, lo);
        accumulate<NC, DS_LO>(acc, hi, lo, qt_s);   // dk += dsᵀ·q
      }
      if (leave_stage(empty, released, st, (it / STAGES) & 1, lane) && it + STAGES < n_items) load_item(it + STAGES);
    }
    const int64_t stride = (int64_t)Kv * HD;
    __nv_bfloat16* out = (wg == 0 ? dv : dk) + ((int64_t)b * T_len + k0) * stride + (int64_t)kvh * HD;
    store_rows<NC>(acc, wg == 0 ? 1.f : scale, out, stride, r0, c0, T_len - k0);
  }
}

// (c) dq of one 64-query tile of one head: warpgroup 0 forms p(1 - t²) and hands it over, warpgroup 1
// forms ds from it and accumulates dq over the whole head dim.  Warpgroup 0 has no product of its
// own to wait for, so its next tile's scores and transcendentals overlap warpgroup 1's products.
// Thread 0 starts the ring; after that the last warp to leave a stage refills it.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_dq_tc(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
             const float* __restrict__ lse, const float* __restrict__ D, __nv_bfloat16* __restrict__ dq,
             int S, int T_len, int H, int Kv, int causal, int window, float cap, float scale, int n_qt) {
  constexpr int HD = NC * BOX;
  constexpr int TILE = tile_bytes(NC);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  const uint32_t q_s = smem_addr(smem);
  const uint32_t do_s = q_s + TILE;
  const uint32_t k_s = do_s + TILE;                 // stage st at k_s + st TILE
  const uint32_t v_s = k_s + STAGES * TILE;
  float* handed = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * TILE);   // p(1 - t²)
  const uint32_t q_full = smem_addr(handed + XCHG_FLOATS);
  const uint32_t full = q_full + 8;                 // then empty: one of each per stage
  const uint32_t empty = full + 8 * STAGES;
  uint32_t* released = reinterpret_cast<uint32_t*>(handed + XCHG_FLOATS) + 2 * (1 + 2 * STAGES);   // per stage

  const int heads = gridDim.x / n_qt;               // H·B; the heaviest query tiles (the last) come first
  const int qt = n_qt - 1 - (int)blockIdx.x / heads;
  const int h = (int)blockIdx.x % heads % H;
  const int b = (int)blockIdx.x % heads / H;
  const int kvh = h / (H / Kv);
  const int q0 = qt * BQ;
  int kt_lo, kt_hi;
  key_tiles(q0, BQ, BK, S, T_len, causal, window, kt_lo, kt_hi);
  const int n_items = kt_hi - kt_lo;

  // K and V of item it into its stage (by one thread)
  auto load_keys = [&](int it) {
    const int st = it % STAGES;
    const int k0 = (kt_lo + it) * BK;
    mbar_arrive_tx(full + 8 * st, 2 * TILE);
    tma_tile<NC>(k_s + st * TILE, &k_map, full + 8 * st, kvh, k0, b);
    tma_tile<NC>(v_s + st * TILE, &v_map, full + 8 * st, kvh, k0, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, NWARPS);            // one arrival per warp
      released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_items > 0) {
    mbar_arrive_tx(q_full, 2 * TILE);
    tma_tile<NC>(q_s, &q_map, q_full, h, q0, b);
    tma_tile<NC>(do_s, &do_map, q_full, h, q0, b);
    for (int it = 0; it < STAGES && it < n_items; ++it) load_keys(it);
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  {
    const int t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + lane / 4;        // accumulator rows r0 and r0 + 8: queries
    const int c0 = 2 * (lane % 4);
    const bool use_cap = cap > 0.f;
    const float pre = use_cap ? scale / cap : scale * LOG2E;
    const float post = cap * LOG2E;
    const int64_t row = ((int64_t)b * H + h) * S + q0;
    float lse2[2], d_r[2];                          // of rows r0 and r0 + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      lse2[half] = q0 + r < S ? lse[row + r] * LOG2E : 0.f;
      d_r[half] = q0 + r < S ? D[row + r] : 0.f;
    }
    float acc[HD / 2];                              // dq (warpgroup 1): rows queries, columns hd
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    if (n_items > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % STAGES;
      const int k0 = (kt_lo + it) * BK;
      const uint32_t kt_s = k_s + st * TILE, vt_s = v_s + st * TILE;
      const bool inner = interior(q0, k0, S, T_len, causal, window);
      float x[32];
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      if (wg == 0) {
        scores<NC>(x, q_s, kt_s);                   // s = q·kᵀ: rows queries, columns keys
        with_flags(use_cap, !inner, [&](auto cap_f, auto mask_f) {
          probs_by_query(cap_f, mask_f, x, lse2, pre, post, q0, k0, r0, c0, S, T_len, causal, window);
        });
        if (it > 0) bar_sync(BAR_TAKEN);            // warpgroup 1 took the previous tile
        put(handed, t, x);
        bar_arrive(BAR_HANDED);
      } else {
        scores<NC>(x, do_s, vt_s);                  // dp = do·vᵀ
        float pd[32];
        uint32_t hi[4][4], lo[4][4];
        bar_sync(BAR_HANDED);
        get(handed, t, pd);
        if (it + 1 < n_items) bar_arrive(BAR_TAKEN);
#pragma unroll
        for (int e = 0; e < 32; ++e) x[e] = ds_of(pd[e], x[e], d_r[(e / 2) % 2]);
        to_fragments(x, hi, lo);
        accumulate<NC, DS_LO>(acc, hi, lo, kt_s);   // dq += ds·k
      }
      if (leave_stage(empty, released, st, (it / STAGES) & 1, lane) && it + STAGES < n_items && lane == 0)
        load_keys(it + STAGES);
    }
    const int64_t stride = (int64_t)H * HD;
    __nv_bfloat16* out = dq + ((int64_t)b * S + q0) * stride + (int64_t)h * HD;
    if (wg == 1) store_rows<NC>(acc, scale, out, stride, r0, c0, S - q0);
  }
}

}  // namespace tc

int nc_of(int hd) { return hd / 64; }

bool shape_ok(int B, int S, int T_len, int H, int Kv, int hd, int dtype) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || hd <= 0 || hd > MAX_HD) return false;
  if (B > 65535 || H > 65535) return false;
  return dtype == 0 || (dtype == 1 && hd % 64 == 0);
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

int encode_maps(Maps& m, const void* q, const void* k, const void* v, const void* dout, int B, int S, int T_len,
                int H, int Kv, int hd) {
  using namespace hopper;
  if (encode_tiled() == nullptr) return ERR_NO_ENCODE;
  if (make_map(&m.q, q, B, S, H, hd, tc::BQ) != CUDA_SUCCESS ||
      make_map(&m.dout, dout, B, S, H, hd, tc::BQ) != CUDA_SUCCESS ||
      make_map(&m.k, k, B, T_len, Kv, hd, tc::BK) != CUDA_SUCCESS ||
      make_map(&m.v, v, B, T_len, Kv, hd, tc::BK) != CUDA_SUCCESS)
    return ERR_ENCODE;
  return 0;
}

template <int NC>
int launch_dkdv_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* D,
                   void* dk, void* dv, int B, int S, int T_len, int H, int Kv, int causal, int window, float cap,
                   float scale, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  Maps m;
  int status = encode_maps(m, q, k, v, dout, B, S, T_len, H, Kv, 64 * NC);
  if (status) return status;
  auto kern = tc::fa_bwd_dkdv_tc<NC>;
  const int smem = tc::smem_dkdv(NC);
  cudaError_t err = opt_in_once(kern, smem, done);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (T_len + tc::BK - 1) / tc::BK;
  const long long blocks = (long long)n_kt * Kv * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  kern<<<(unsigned)blocks, tc::NTHREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, lse, D, static_cast<bf*>(dk),
                                                         static_cast<bf*>(dv), S, T_len, H, Kv, causal, window,
                                                         cap, scale, n_kt);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* D,
                 void* dq, int B, int S, int T_len, int H, int Kv, int causal, int window, float cap, float scale,
                 cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  Maps m;
  int status = encode_maps(m, q, k, v, dout, B, S, T_len, H, Kv, 64 * NC);
  if (status) return status;
  auto kern = tc::fa_bwd_dq_tc<NC>;
  const int smem = tc::smem_dq(NC);
  cudaError_t err = opt_in_once(kern, smem, done);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + tc::BQ - 1) / tc::BQ;
  const long long blocks = (long long)n_qt * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, tc::NTHREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, lse, D,
                                                         static_cast<__nv_bfloat16*>(dq), S, T_len, H, Kv, causal,
                                                         window, cap, scale, n_qt);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor-core kernels, hd a multiple of 64).
// Each returns 0 when launched, else a cudaError_t or one of hopper.cuh's negative codes.  Tensors
// are contiguous: q, o, do, dq [B, S, H, hd]; k, v, dk, dv [B, T, Kv, hd]; lse and D f32 [B, H, S].

extern "C" int fa_bwd_dot(const void* o, const void* dout, void* D, int B, int S, int H, int hd, int dtype,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + DOT_THREADS / 32 - 1) / (DOT_THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fa_bwd_rowdot<float><<<(unsigned)blocks, DOT_THREADS, 0, st>>>(static_cast<const float*>(o),
                                                                 static_cast<const float*>(dout),
                                                                 static_cast<float*>(D), B, S, H, hd);
  else
    fa_bwd_rowdot<__nv_bfloat16><<<(unsigned)blocks, DOT_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(D), B,
        S, H, hd);
  return (int)cudaGetLastError();
}

extern "C" int fa_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* D, void* dk, void* dv, int B, int S, int T_len, int H, int Kv, int hd,
                           int causal, int window, float softcap, float scale, int dtype, void* stream) {
  if (!shape_ok(B, S, T_len, H, Kv, hd, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
  if (dtype == 0) {
    static bool done[MAX_DEVICES] = {};
    const int smem = scalar::smem_dkdv(hd);
    cudaError_t err = opt_in_once(scalar::fa_bwd_dkdv_scalar, smem, done);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T_len + scalar::BK - 1) / scalar::BK, Kv, B);
    scalar::fa_bwd_dkdv_scalar<<<grid, scalar::NTHREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, d, static_cast<float*>(dk), static_cast<float*>(dv), S, T_len, H, Kv,
        hd, causal, window, softcap, scale);
    return (int)cudaGetLastError();
  }
  switch (nc_of(hd)) {
    case 1: return launch_dkdv_tc<1>(q, k, v, dout, l, d, dk, dv, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
    case 2: return launch_dkdv_tc<2>(q, k, v, dout, l, d, dk, dv, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
    case 3: return launch_dkdv_tc<3>(q, k, v, dout, l, d, dk, dv, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
    default: return launch_dkdv_tc<4>(q, k, v, dout, l, d, dk, dv, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
  }
}

extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                         const void* D, void* dq, int B, int S, int T_len, int H, int Kv, int hd, int causal,
                         int window, float softcap, float scale, int dtype, void* stream) {
  if (!shape_ok(B, S, T_len, H, Kv, hd, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
  if (dtype == 0) {
    static bool done[MAX_DEVICES] = {};
    const int smem = scalar::smem_dq(hd);
    cudaError_t err = opt_in_once(scalar::fa_bwd_dq_scalar, smem, done);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + scalar::BQ - 1) / scalar::BQ, H, B);
    scalar::fa_bwd_dq_scalar<<<grid, scalar::NTHREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, d, static_cast<float*>(dq), S, T_len, H, Kv, hd, causal, window,
        softcap, scale);
    return (int)cudaGetLastError();
  }
  switch (nc_of(hd)) {
    case 1: return launch_dq_tc<1>(q, k, v, dout, l, d, dq, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
    case 2: return launch_dq_tc<2>(q, k, v, dout, l, d, dq, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
    case 3: return launch_dq_tc<3>(q, k, v, dout, l, d, dq, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
    default: return launch_dq_tc<4>(q, k, v, dout, l, d, dq, B, S, T_len, H, Kv, causal, window, softcap, scale, st);
  }
}

// The geometry this library derives for (dtype, hd), for the wrapper to hold
// against its own: {variant (0 scalar, 1 tensor core: wgmma), head dim the
// kernels see, queries per tile, keys per tile, threads per block, dynamic
// shared bytes of dkdv, of dq}.  Returns 0, or cudaErrorInvalidValue.
extern "C" int fa_bwd_geometry(int dtype, int hd, long long* out) {
  if (hd <= 0 || hd > MAX_HD) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const long long g[7] = {0, hd, scalar::BQ, scalar::BK, scalar::NTHREADS, scalar::smem_dkdv(hd),
                            scalar::smem_dq(hd)};
    for (int i = 0; i < 7; ++i) out[i] = g[i];
    return 0;
  }
  if (dtype == 1) {
    const int nc = (hd + 63) / 64;
    const long long g[7] = {1, 64 * nc, tc::BQ, tc::BK, tc::NTHREADS, tc::smem_dkdv(nc), tc::smem_dq(nc)};
    for (int i = 0; i < 7; ++i) out[i] = g[i];
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_bwd_error_string(int err) { return hopper::error_string(err); }
