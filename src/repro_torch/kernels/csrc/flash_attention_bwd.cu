// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// The Pallas kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py)
// is forward-only: the reference trains through JAX's autodiff of its blocked
// jnp twin (src/repro/models/attention.py:80-163).  The port's forward is a
// CUDA kernel (flash_attention.cu), so its gradient is these kernels.  Same
// function as that autodiff: for s = scale·q·kᵀ, t = tanh(s/cap), the logit
// cap·t (s itself with no cap), p = exp(logit - lse) under the causal /
// sliding-window mask (p = 0 outside it) and o = p·v,
//
//   dv = pᵀ·do,   dp = do·vᵀ,   ds = p∘(dp - D)∘(1 - t²),   D = rowsum(do∘o),
//   dq = scale·ds·k,   dk = scale·dsᵀ·q,
//
// with (1 - t²) = 1 when there is no cap, and dk, dv summed over the G query
// heads that share a KV head (GQA).  lse is the forward's f32 [B, H, S]
// log-sum-exp (natural log).  q_offset is 0: training attends a sequence to
// itself.
//
// Structure (FlashAttention-2's: no atomics, deterministic), three kernels:
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
// loaded as zeros and masked out.
//
// Two variants, chosen by dtype (a fixed rule, as in the forward):
//
// * bf16: the products on the tensor cores, `mma.sync.aligned.m16n8k16` with
//   bf16 operands and f32 accumulators, fed by `ldmatrix` from padded shared
//   tiles (rows 16 bytes longer than the data, so the 8 row addresses of an
//   8x8 matrix fall in 8 different bank groups).  8 warps per block.  Per
//   64-query x 32-key tile, each warp computes a 16x16 piece of s = q·kᵀ and
//   dp = do·vᵀ (contraction over hd), turns it into p and ds and writes them to
//   shared memory; then every warp reads the whole p and ds tiles for the
//   second products, each warp owning an hd/8-column slice of dk and dv (or of
//   dq): 64 f32 accumulators a thread at hd 256.  p and ds go into the second
//   products as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), into one
//   accumulator (as the forward does for P·V): bf16 alone gives each weight a
//   relative error up to 2^-9, and the keys (for dv, dk) and queries (for dq)
//   whose gradient is a sum of few large terms then fall outside the bf16
//   gate.  Q / dO tiles (dkdv) and K / V tiles (dq) are double-buffered with
//   16-byte `cp.async`.  The wrapper zero-pads hd to a multiple of 64.
// * f32: scalar FMAs on 16-query x 16-key tiles, one score per thread.  TF32
//   would miss the reference's 2e-5 f32 gate; f32 runs only in the
//   card-vs-CPU checks.
//
// Bound.  gemma2's training shape, bf16 B4 S=T=2048 H8 Kv4 hd256, causal:
// 67.1 M live (query, key) pairs, and the function needs five products of
// 2·hd FLOP each per pair (s, dp, dv, dk, dq): 172 GFLOP against 101 MB of
// I/O, so the bound is operations, 0.174 ms at 989 TFLOP/s.  This design
// computes s and dp twice (once in each of (b) and (c)), 1.4x that work, on
// `mma.sync` (not `wgmma`, which alone reaches the full rate), and the hi + lo
// parts add half again to the second products.
//
// Shared memory above 48 KB is opted into once per instantiation and device,
// never per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

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
// bf16: mma.sync on padded shared tiles
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;                  // queries per tile
constexpr int BK = 32;                  // keys per tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PS_LD = BK + 8;           // p / ds tiles [BQ][BK + 8] bf16: 80-byte rows

// NC = 64-column groups of the (padded) head dim; rows are 16 bytes longer than the data.
__host__ __device__ constexpr int row_bytes(int nc) { return 2 * (64 * nc + 8); }
__host__ __device__ constexpr int ps_bytes() { return BQ * PS_LD * 2; }
// dkdv: K and V once, Q and dO in two stages, p and ds (hi, lo), lse and D in two stages
__host__ __device__ constexpr int smem_dkdv(int nc) {
  return 2 * BK * row_bytes(nc) + 2 * 2 * BQ * row_bytes(nc) + 4 * ps_bytes() + 2 * 2 * BQ * 4;
}
// dq: Q and dO once, K and V in two stages, ds (hi, lo), lse and D
__host__ __device__ constexpr int smem_dq(int nc) {
  return 2 * BQ * row_bytes(nc) + 2 * 2 * BK * row_bytes(nc) + 2 * ps_bytes() + 2 * BQ * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every group but the newest has landed (this thread's copies; a barrier follows)
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// rows x (64 NC) bf16 from global rows `stride` elements apart into a padded shared tile;
// rows at or past `valid` are zero
template <int NC>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int64_t stride, int rows,
                                          int valid) {
  constexpr int CH = 8 * NC;   // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < valid;
    cp_async16(dst + r * row_bytes(NC) + c * 16, ok ? src + r * stride + c * 8 : src, ok);
  }
}

// `rows` f32 values (lse or D of a query tile) into shared memory; zeros past `valid`
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src, int rows, int valid) {
  for (int r = threadIdx.x; r < rows; r += NTHREADS) cp_async4(dst + 4 * r, r < valid ? src + r : src, r < valid);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// c (16x8, f32) += a (16x16, bf16, row-major fragment) · b (16x8, bf16, column-major fragment)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two values as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi), ~16 bits of mantissa together.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// A warp's 16 x 16 piece of a = A·Bᵀ over the padded head dim: A rows a_row0.. of
// one shared tile (q or do), B rows b_row0.. of another (k or v), both
// [rows][64 NC] row-major.  c[n] holds keys b_row0 + 8n ..: element e of c[n]
// sits at row a_row0 + g + 8 (e / 2), column b_row0 + 8n + 2 (lane % 4) + e % 2.
template <int NC>
__device__ __forceinline__ void scores16(uint32_t a_tile, int a_row0, uint32_t b_tile, int b_row0, int lane,
                                         float (&c)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  // A (16x16): lanes 0-15 rows 0-15 at column 0, lanes 16-31 the same rows at column 8
  const uint32_t a_addr = a_tile + (a_row0 + (lane & 15)) * row_bytes(NC) + (lane >> 4) * 16;
  // B as [n][k]: matrices (keys 0-7, k 0-7), (keys 0-7, k 8-15), (keys 8-15, k 0-7), (keys 8-15, k 8-15)
  const uint32_t b_addr = b_tile + (b_row0 + (lane & 7) + ((lane >> 4) << 3)) * row_bytes(NC) + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a_addr + kk * 32, a);
    ldsm_x4(b_addr + kk * 32, b);
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma(c[0], a, b0);
    mma(c[1], a, b1);
  }
}

// s and dp of a warp's 16 x 16 piece (queries qm.., keys kn.. of the tiles) into ds and, with
// WITH_P, p, written as hi and lo bf16 parts to the [BQ][PS_LD] tiles (row = query, column = key).
template <int NC, bool WITH_P>
__device__ __forceinline__ void p_and_ds_tiles(uint32_t q_tile, uint32_t do_tile, uint32_t k_tile, uint32_t v_tile,
                                               const float* lse_s, const float* D_s, int qm, int kn, int q0, int k0,
                                               int S, int T_len, int causal, int window, float cap, float scale,
                                               int lane, __nv_bfloat16* p_hi, __nv_bfloat16* p_lo,
                                               __nv_bfloat16* ds_hi, __nv_bfloat16* ds_lo) {
  float s[2][4], dp[2][4];
  scores16<NC>(q_tile, qm, k_tile, kn, lane, s);
  scores16<NC>(do_tile, qm, v_tile, kn, lane, dp);
  const int g = lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = qm + g + 8 * half;
    const float lse_i = lse_s[r], d_i = D_s[r];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = kn + 8 * n + col;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        prob_and_ds(s[n][2 * half + e], dp[n][2 * half + e], lse_i, d_i, scale, cap,
                    live(q0 + r, k0 + c + e, S, T_len, causal, window), p[e], ds[e]);
      uint32_t hi, lo;
      if (WITH_P) {
        split_bf16(p[0], p[1], hi, lo);
        *reinterpret_cast<uint32_t*>(p_hi + r * PS_LD + c) = hi;
        *reinterpret_cast<uint32_t*>(p_lo + r * PS_LD + c) = lo;
      }
      split_bf16(ds[0], ds[1], hi, lo);
      *reinterpret_cast<uint32_t*>(ds_hi + r * PS_LD + c) = hi;
      *reinterpret_cast<uint32_t*>(ds_lo + r * PS_LD + c) = lo;
    }
  }
}

// Writes a warp's accumulators acc[m][n] (rows row0 + 16 m .., columns col0 + 8 n ..), times
// mult, as bf16 into rows of `out` that are `stride` elements apart; rows at or past `valid` are skipped.
template <int M, int NC>
__device__ __forceinline__ void store_acc(const float (&acc)[M][NC][4], float mult, __nv_bfloat16* out,
                                          int64_t stride, int col0, int valid, int lane) {
  const int g = lane / 4, col = col0 + 2 * (lane % 4);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * m + g + 8 * half;
      if (r >= valid) continue;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + r * stride + col + 8 * n) =
            __floats2bfloat162_rn(mult * acc[m][n][2 * half], mult * acc[m][n][2 * half + 1]);
    }
}

// (b) dk and dv of one key tile of one KV head: warp w owns columns [8 NC w, 8 NC (w + 1)) of both,
// for all 32 keys (two 16-row m-tiles).
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ D, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int S, int T_len, int H, int Kv, int causal, int window,
               float cap, float scale) {
  constexpr int HD = 64 * NC;
  constexpr int RB = row_bytes(NC);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + BK * RB;
  const uint32_t q_s = v_s + BK * RB;               // stage st at q_s + st BQ RB
  const uint32_t do_s = q_s + 2 * BQ * RB;
  uint8_t* ps = smem + (do_s + 2 * BQ * RB - base);
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(ps);
  __nv_bfloat16* p_lo = p_hi + BQ * PS_LD;
  __nv_bfloat16* ds_hi = p_lo + BQ * PS_LD;
  __nv_bfloat16* ds_lo = ds_hi + BQ * PS_LD;
  float* lse_s = reinterpret_cast<float*>(ds_lo + BQ * PS_LD);   // [2][BQ]
  float* D_s = lse_s + 2 * BQ;                                    // [2][BQ]

  const int kt = blockIdx.x;                      // lighter tiles (later keys) come later
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK;
  const int group = H / Kv;
  const int64_t q_stride = (int64_t)H * HD, kv_stride = (int64_t)Kv * HD;
  const int k_rows = min(BK, T_len - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qm = 16 * (warp % 4), kn = 16 * (warp / 4);   // this warp's piece of the score tile
  const int col0 = 8 * NC * warp;                         // and its columns of dk and dv

  int qt_lo, qt_hi;
  query_tiles(k0, BK, BQ, S, T_len, causal, window, qt_lo, qt_hi);
  const int nq = qt_hi - qt_lo;
  const int n_items = group * nq;                 // (query head of the group, query tile)

  auto load_item = [&](int it, int st) {
    const int h = kvh * group + it / nq;
    const int q0 = (qt_lo + it % nq) * BQ;
    const int q_rows = min(BQ, S - q0);
    const int64_t off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
    load_tile<NC>(q_s + st * BQ * RB, q + off, q_stride, BQ, q_rows);
    load_tile<NC>(do_s + st * BQ * RB, dout + off, q_stride, BQ, q_rows);
    const int64_t row = ((int64_t)b * H + h) * S + q0;
    load_vec(smem_addr(lse_s + st * BQ), lse + row, BQ, q_rows);
    load_vec(smem_addr(D_s + st * BQ), D + row, BQ, q_rows);
  };

  float acc_dk[2][NC][4], acc_dv[2][NC][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dk[m][n][e] = acc_dv[m][n][e] = 0.f;

  if (n_items > 0) {
    const int64_t koff = ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * HD;
    load_tile<NC>(k_s, k + koff, kv_stride, BK, k_rows);
    load_tile<NC>(v_s, v + koff, kv_stride, BK, k_rows);
    load_item(0, 0);
  }
  cp_async_commit();

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) load_item(it + 1, st ^ 1);   // its stage was released at the end of it - 1
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const int q0 = (qt_lo + it % nq) * BQ;
    const uint32_t qt_s = q_s + st * BQ * RB, dot_s = do_s + st * BQ * RB;
    p_and_ds_tiles<NC, true>(qt_s, dot_s, k_s, v_s, lse_s + st * BQ, D_s + st * BQ, qm, kn, q0, k0, S, T_len,
                       causal, window, cap, scale, lane, p_hi, p_lo, ds_hi, ds_lo);
    __syncthreads();

    // dv += pᵀ·do and dk += dsᵀ·q, 16 queries per k-step.  pᵀ and dsᵀ (keys x queries) come
    // transposed out of the [query][key] tiles; do and q ([query][column]) are the
    // column-major B operand through the transposing load.
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t a_phi[2][4], a_plo[2][4], a_dshi[2][4], a_dslo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int off = (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * PS_LD + 16 * m + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(smem_addr(p_hi + off), a_phi[m]);
        ldsm_x4_t(smem_addr(p_lo + off), a_plo[m]);
        ldsm_x4_t(smem_addr(ds_hi + off), a_dshi[m]);
        ldsm_x4_t(smem_addr(ds_lo + off), a_dslo[m]);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const uint32_t boff = (16 * ks + (lane & 15)) * RB + 2 * (col0 + 8 * n);
        uint32_t b_do[2], b_q[2];
        ldsm_x2_t(dot_s + boff, b_do);
        ldsm_x2_t(qt_s + boff, b_q);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma(acc_dv[m][n], a_phi[m], b_do);
          mma(acc_dv[m][n], a_plo[m], b_do);
          mma(acc_dk[m][n], a_dshi[m], b_q);
          mma(acc_dk[m][n], a_dslo[m], b_q);
        }
      }
    }
    __syncthreads();   // this stage and the p / ds tiles are free again
  }

  const int64_t out0 = ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * HD;
  store_acc<2, NC>(acc_dk, scale, dk + out0, kv_stride, col0, k_rows, lane);
  store_acc<2, NC>(acc_dv, 1.f, dv + out0, kv_stride, col0, k_rows, lane);
}

// (c) dq of one query tile of one head: warp w owns columns [8 NC w, 8 NC (w + 1)) for all 64 queries.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_bwd_dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ D, __nv_bfloat16* __restrict__ dq,
             int S, int T_len, int H, int Kv, int causal, int window, float cap, float scale) {
  constexpr int HD = 64 * NC;
  constexpr int RB = row_bytes(NC);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + BQ * RB;
  const uint32_t k_s = do_s + BQ * RB;             // stage st at k_s + st BK RB
  const uint32_t v_s = k_s + 2 * BK * RB;
  uint8_t* ps = smem + (v_s + 2 * BK * RB - base);
  __nv_bfloat16* ds_hi = reinterpret_cast<__nv_bfloat16*>(ps);
  __nv_bfloat16* ds_lo = ds_hi + BQ * PS_LD;
  float* lse_s = reinterpret_cast<float*>(ds_lo + BQ * PS_LD);   // [BQ]
  float* D_s = lse_s + BQ;                                        // [BQ]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - (int)blockIdx.x;   // heaviest first: the last queries see the most keys
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / (H / Kv);
  const int64_t q_stride = (int64_t)H * HD, kv_stride = (int64_t)Kv * HD;
  const int q_rows = min(BQ, S - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qm = 16 * (warp % 4), kn = 16 * (warp / 4);
  const int col0 = 8 * NC * warp;

  int kt_lo, kt_hi;
  key_tiles(q0, BQ, BK, S, T_len, causal, window, kt_lo, kt_hi);
  const int n_items = kt_hi - kt_lo;

  auto load_keys = [&](int kt, int st) {
    const int k0 = kt * BK;
    const int64_t off = ((int64_t)b * T_len + k0) * kv_stride + (int64_t)kvh * HD;
    load_tile<NC>(k_s + st * BK * RB, k + off, kv_stride, BK, min(BK, T_len - k0));
    load_tile<NC>(v_s + st * BK * RB, v + off, kv_stride, BK, min(BK, T_len - k0));
  };

  float acc[4][NC][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  if (n_items > 0) {
    const int64_t off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
    load_tile<NC>(q_s, q + off, q_stride, BQ, q_rows);
    load_tile<NC>(do_s, dout + off, q_stride, BQ, q_rows);
    const int64_t row = ((int64_t)b * H + h) * S + q0;
    load_vec(smem_addr(lse_s), lse + row, BQ, q_rows);
    load_vec(smem_addr(D_s), D + row, BQ, q_rows);
    load_keys(kt_lo, 0);
  }
  cp_async_commit();

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) load_keys(kt_lo + it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const int k0 = (kt_lo + it) * BK;
    const uint32_t kt_s = k_s + st * BK * RB, vt_s = v_s + st * BK * RB;
    p_and_ds_tiles<NC, false>(q_s, do_s, kt_s, vt_s, lse_s, D_s, qm, kn, q0, k0, S, T_len, causal, window, cap,
                              scale, lane, nullptr, nullptr, ds_hi, ds_lo);
    __syncthreads();

    // dq += ds·k, 16 keys per k-step; k ([key][column]) is the column-major B operand
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b_k[NC][2];
#pragma unroll
      for (int n = 0; n < NC; ++n) ldsm_x2_t(kt_s + (16 * ks + (lane & 15)) * RB + 2 * (col0 + 8 * n), b_k[n]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int off = (16 * m + (lane & 15)) * PS_LD + 16 * ks + (lane >> 4) * 8;
        uint32_t a_hi[4], a_lo[4];
        ldsm_x4(smem_addr(ds_hi + off), a_hi);
        ldsm_x4(smem_addr(ds_lo + off), a_lo);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          mma(acc[m][n], a_hi, b_k[n]);
          mma(acc[m][n], a_lo, b_k[n]);
        }
      }
    }
    __syncthreads();
  }

  store_acc<4, NC>(acc, scale, dq + ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD, q_stride, col0, q_rows,
                   lane);
}

}  // namespace tc

// Raises a kernel's dynamic shared-memory limit to `smem` once per device: the
// attribute stays set for the process, and setting it on every launch was seen
// to cost ~1.4 ms a launch on short calls (PERF.md §6).
template <typename Kernel>
cudaError_t opt_in_once(Kernel kern, int smem, bool (&done)[MAX_DEVICES]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

int nc_of(int hd) { return hd / 64; }

bool shape_ok(int B, int S, int T_len, int H, int Kv, int hd, int dtype) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || hd <= 0 || hd > MAX_HD) return false;
  if (B > 65535 || H > 65535) return false;
  return dtype == 0 || (dtype == 1 && hd % 64 == 0);
}

template <int NC>
int launch_dkdv_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* D,
                   void* dk, void* dv, int B, int S, int T_len, int H, int Kv, int causal, int window, float cap,
                   float scale, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  auto kern = tc::fa_bwd_dkdv_tc<NC>;
  const int smem = tc::smem_dkdv(NC);
  cudaError_t err = opt_in_once(kern, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + tc::BK - 1) / tc::BK, Kv, B);
  using bf = __nv_bfloat16;
  kern<<<grid, tc::NTHREADS, smem, stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                             static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
                                             static_cast<bf*>(dk), static_cast<bf*>(dv), S, T_len, H, Kv,
                                             causal, window, cap, scale);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* D,
                 void* dq, int B, int S, int T_len, int H, int Kv, int causal, int window, float cap, float scale,
                 cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  auto kern = tc::fa_bwd_dq_tc<NC>;
  const int smem = tc::smem_dq(NC);
  cudaError_t err = opt_in_once(kern, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + tc::BQ - 1) / tc::BQ, H, B);
  using bf = __nv_bfloat16;
  kern<<<grid, tc::NTHREADS, smem, stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                             static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
                                             static_cast<bf*>(dq), S, T_len, H, Kv, causal, window, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor-core kernels, hd a multiple of 64).
// Each returns 0 when launched, else a cudaError_t.  Tensors are contiguous: q, o, do, dq
// [B, S, H, hd]; k, v, dk, dv [B, T, Kv, hd]; lse and D f32 [B, H, S].

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
// against its own: {variant (0 scalar, 1 tensor core), head dim the kernels
// see, queries per tile, keys per tile, threads per block, dynamic shared
// bytes of dkdv, of dq}.  Returns 0, or cudaErrorInvalidValue.
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

extern "C" const char* fa_bwd_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
