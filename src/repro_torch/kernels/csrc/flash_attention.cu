// Fused flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body `_attn_kernel`)
// in src/repro/kernels/flash_attention.py.  Same function: online-softmax
// attention with f32 running max / sum / accumulator, GQA (query head h reads
// KV head h / (H / Kv)), causal and sliding-window masks on absolute positions
// shifted by q_offset, the Gemma2 logit softcap cap·tanh(s/cap) applied before
// the mask, masked scores set to the finite -1e30, the output acc / max(l,
// 1e-30) in q's dtype, and tiles that no query of the block can see skipped.
// The TPU kernel walks KV tiles as the innermost sequential grid axis with
// m / l / acc in VMEM scratch; blocks on a GPU run in no order, so here the KV
// walk is a loop inside the block over the live tiles [k_lo, k_hi) only.
//
// Two kernels, chosen by dtype (a fixed rule, not a fallback):
//
// * bf16: `fa_fwd_tc`, the products on the tensor cores (`wgmma`).  The main
//   path runs only this one.
// * f32: `fa_fwd_scalar`, scalar f32 FMAs.  TF32 `wgmma` would miss the
//   reference's 2e-5 f32 gate; f32 runs only in the card-vs-CPU checks.
//
// Bound.  At the main path's long prompts, bf16 B1 S=T=4608 H8 Kv4 hd256
// (window 4096, softcap 50) and B1 S=T=4096 H32 Kv8 hd128 (causal), the work
// is 86 and 137 GFLOP against 57 and 84 MB of I/O: far above the H100's ridge
// point, so the bound is operations, the bf16 tensor cores' 989 TFLOP/s:
// 0.0869 and 0.139 ms.  The scalar kernel, which ran bf16 too before this
// design, took 5.4 and 9.4 ms there (~16 TFLOP/s).  What held it back, and
// what the bf16 kernel does about each:
//
// 1. Scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak).  Here S = Q·Kᵀ is
//    `wgmma.m64nBKk16` with Q and K both K-major in shared memory, and
//    O += P·V is the register-A form: the f32 score fragment and the bf16 A
//    fragment have the same thread ownership, so P becomes bf16 in the
//    registers that held S, with no shuffle (as hi + lo parts, for accuracy:
//    see fa_fwd_tc).  V is read MN-major (the descriptor's transpose bit): no
//    transposing copy.
// 2. bf16 widened to f32 in shared memory.  Tiles stay bf16, in the 128-byte
//    swizzle that the `wgmma` descriptors read: Q 16 KB per 64 columns, K and
//    V 8 or 16 KB per 64 columns per stage (193 KB in all at hd 256).
// 3. Synchronous copies.  TMA copies Q once and K and V into a 2-stage ring
//    tracked by mbarriers (full: the copy's bytes landed; empty: every warp
//    is done with the stage), so the next tile's copy overlaps this tile's
//    products.  The last warp to leave a stage issues its refill.
// 4. A 32-key tile, one key per lane, with probabilities broadcast by shuffle.
//    Tiles are 128 query rows (two warpgroups of 64) by BK = 128 keys
//    (hd <= 128) or 64 (hd > 128, for shared memory); each thread holds 2 rows
//    of its warpgroup's tile, and row max and sum reduce over the 4 lanes of a
//    quad (the sum only once, at the end).
// 5. Precise `tanhf` / `expf` and a mask test on every score.  bf16 uses
//    `tanh.approx` and `ex2.approx` with scale·log2(e) folded into the
//    scores (their error is ~1e-3 of a score, against the bf16 gate's 2e-2),
//    and each warpgroup tests the mask only on boundary tiles: the diagonal,
//    the window's edge and a ragged T tail (TMA zero-fills keys past T, which
//    would score 0, not -1e30).  Interior tiles skip it.
//
// Shapes.  Each tensor map keeps S (or T) as its own dimension, (hd, heads,
// S or T, B), so the last q or KV tile of a batch row is zero-filled by TMA
// instead of reading the next row, and columns past hd of a 64-column box are
// zero too: a head dim that is not a multiple of 16 pads the contraction with
// zeros, and one that is not a multiple of 64 (80) ends in a partial box.
// TMA needs 16-byte strides, so the bf16 kernel takes hd % 8 == 0; the wrapper
// zero-pads a head dim of 4 mod 8.  Blocks are launched heaviest first (the
// last q tiles, which see the most causal keys) over all heads, for the tail
// of the wave.
//
// Both kernels may also write each row's log-sum-exp of its scores, f32 [B, H,
// S] in natural-log units (lse = m + log l), which the backward in
// flash_attention_bwd.cu reads to recompute the probabilities.  The pointer
// is null for serving, which then runs exactly as before.
//
// Masked scores take the reference's finite -1e30, not -inf: a row whose
// first live tile is fully masked then gets exp(0) weights that the first
// real key rescales away (corr = exp(-1e30 - m) = 0), where -inf would give
// exp(-inf + inf) = NaN.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 256;
constexpr float BIG_NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32: scalar FMAs, one block of 8 warps per 64 query rows, 32-key tiles
// ---------------------------------------------------------------------------

namespace scalar {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per tile: one per lane
constexpr int NWARPS = 8;
constexpr int ROWS = BQ / NWARPS;      // query rows per warp
constexpr int NTHREADS = NWARPS * 32;

__host__ __device__ constexpr int smem_bytes(int hd) {
  return (int)sizeof(float) * (BQ * hd + BK * (hd + 4) + BK * hd);
}

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

// Copy `rows` rows of hd floats (global row stride `stride` elements) into
// shared memory with row stride `ld`; rows at or past `valid` are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t stride,
                                          int rows, int valid, int hd) {
  const int hd4 = hd >> 2;
  for (int idx = threadIdx.x; idx < rows * hd4; idx += NTHREADS) {
    const int r = idx / hd4;
    const int d = (idx - r * hd4) << 2;
    const float4 x = r < valid ? *reinterpret_cast<const float4*>(src + r * stride + d)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + d) = x;
  }
}

// One warp owns 8 query rows; for scores lane c owns key c of the tile, for
// P·V lane c owns head-dim columns c, c + 32, ... (NJ of them: 1 for hd <= 32,
// 8 up to 256), with the probabilities broadcast from their lane by shuffle.
template <int NJ>
__global__ void __launch_bounds__(NTHREADS)
fa_fwd_scalar(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ o, float* __restrict__ lse, int S, int T_len, int H, int Kv, int hd,
              int causal, int window, float cap, int q_offset, float scale) {
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
  const float* qb = q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd;
  const float* kb = k + (int64_t)b * T_len * kv_stride + (int64_t)kvh * hd;
  const float* vb = v + (int64_t)b * T_len * kv_stride + (int64_t)kvh * hd;
  float* ob = o + ((int64_t)b * S + q0) * q_stride + (int64_t)h * hd;

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
    if (lse != nullptr && lane == 0) lse[((int64_t)b * H + h) * S + q0 + r] = m[i] + logf(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) ob[r * q_stride + d] = acc[i][j] / denom;
    }
  }
}

template <int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int T_len,
                   int H, int Kv, int hd, int causal, int window, float cap, int q_offset,
                   float scale, cudaStream_t stream) {
  const int smem = smem_bytes(hd);
  auto kern = fa_fwd_scalar<NJ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(o), lse, S,
                                         T_len, H, Kv, hd, causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

cudaError_t forward(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int T_len,
                    int H, int Kv, int hd, int causal, int window, float cap, int q_offset,
                    float scale, cudaStream_t stream) {
  if (hd % 4 != 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (hd <= 32) return launch<1>(q, k, v, o, lse, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
  return launch<8>(q, k, v, o, lse, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
}

}  // namespace scalar

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;                 // query rows per block
constexpr int WG_ROWS = 64;             // query rows per warpgroup
constexpr int NTHREADS = 2 * 128;       // two warpgroups
constexpr int STAGES = 2;               // K / V ring depth
constexpr int BOX = 64;                 // bf16 columns per box: one 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int ALIGN = 1024;             // the 128-byte swizzle repeats every 8 rows

// NC = 64-column boxes per row (hd padded up to a multiple of 64).
__host__ __device__ constexpr int block_kv(int nc) { return nc >= 3 ? 64 : 128; }
__host__ __device__ constexpr int tile_bytes(int rows, int nc) { return rows * nc * ROW_BYTES; }
__host__ __device__ constexpr int barrier_bytes() { return 8 * (1 + 3 * STAGES) + 4 * STAGES; }
__host__ __device__ constexpr int smem_bytes(int nc) {
  return ALIGN + tile_bytes(BQ, nc) + 2 * STAGES * tile_bytes(block_kv(nc), nc) + barrier_bytes();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spins until the barrier's phase of this parity has completed.  A wait of
// ~2^34 cycles (about 9 s) can only be a broken pipeline: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// One box of a (hd, heads, L, B) tensor map into shared memory at dst; the
// barrier's transaction count drops by the box's bytes when it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at addr (1024-byte
// aligned up to a k-step's 32-byte offset).  lbo / sbo in bytes: for K-major
// operands sbo is the 8-row group stride (lbo unused); for the MN-major V, lbo
// is the stride between 64-column boxes and sbo between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from touching an accumulator between wgmma issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two probabilities as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi).  The
// pair carries ~16 bits of mantissa where hi alone carries 8; see the note on
// P·V in fa_fwd_tc.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

// S (+)= A·B, A and B from shared memory, both K-major: m64n64k16, 32 f32 per thread
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// S (+)= A·B, A and B from shared memory, both K-major: m64n128k16, 64 f32 per thread
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O += P·V, P (A) from registers, V (B) MN-major from shared memory: m64n64k16, 32 f32 per thread
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P·V, P (A) from registers, V (B) MN-major from shared memory: m64n128k16, 64 f32 per thread
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P·V, P (A) from registers, V (B) MN-major from shared memory: m64n192k16, 96 f32 per thread
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P·V, P (A) from registers, V (B) MN-major from shared memory: m64n256k16, 128 f32 per thread
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// K and V of tile kt into stage s: the full barriers' transaction counts are
// armed with the tiles' bytes before the copies start.
template <int NC>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map, const CUtensorMap* v_map, uint32_t k_s,
                                        uint32_t v_s, uint32_t k_full, uint32_t v_full, int s, int kt,
                                        int kvh, int b) {
  constexpr int BK = block_kv(NC);
  constexpr int KV_BYTES = tile_bytes(BK, NC);
  mbar_expect_tx(k_full + 8 * s, KV_BYTES);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(k_s + s * KV_BYTES + c * BK * ROW_BYTES, k_map, k_full + 8 * s, c * BOX, kvh, kt * BK, b);
  mbar_expect_tx(v_full + 8 * s, KV_BYTES);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(v_s + s * KV_BYTES + c * BK * ROW_BYTES, v_map, v_full + 8 * s, c * BOX, kvh, kt * BK, b);
}

// One block per 128 query rows of one (batch row, head): two warpgroups of 64
// rows each.  Each thread holds rows r0 and r0 + 8 of its warpgroup's tile:
// accumulator element 4j + e sits in row r0 + 8 (e / 2), column
// 8j + 2 (lane % 4) + e % 2.
//
// The K / V ring.  Thread 0 loads Q and the first STAGES tiles.  After that a
// stage is refilled by the last of the 8 warps to finish with it: each warp
// arrives on the stage's empty barrier and counts itself out on a shared
// counter, and the eighth waits for the barrier (already complete) and starts
// the copies of the tile STAGES ahead.  A separate producer warp would need a
// third warpgroup, and at 384 threads ptxas caps every thread at 168
// registers (setmaxnreg did not lift it: the hd-256 build spilled); at 256
// threads the cap is 255.
//
// P·V.  Rounding P to bf16 alone gives each weight a relative error of up to
// 2^-9; for the first rows of a causal sequence, which average few keys, that
// is more than the bf16 gate allows against the f32 reference (a few elements
// per long prompt fall outside it: scripts/flash_variants.py, "p_hi_only").
// So P goes in as two bf16 parts, hi + lo, and the P·V products run twice,
// into one accumulator: P is then exact to ~2^-17, at the cost of half again
// the tensor-core work.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
          int S, int T_len, int H, int Kv, int hd, int causal, int window, float cap, int q_offset,
          float scale, int n_qt) {
  constexpr int BK = block_kv(NC);
  constexpr int DV = NC * BOX;                      // output columns: hd padded to whole boxes
  constexpr int Q_BYTES = tile_bytes(BQ, NC);
  constexpr int KV_BYTES = tile_bytes(BK, NC);

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  const uint32_t q_s = smem_addr(smem);
  const uint32_t k_s = q_s + Q_BYTES;               // stage s at k_s + s KV_BYTES
  const uint32_t v_s = k_s + STAGES * KV_BYTES;
  const uint32_t q_full = v_s + STAGES * KV_BYTES;  // then k_full, v_full, empty: one per stage
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + (empty - q_s) + 8 * STAGES);   // per stage

  // heaviest first: the first H·B blocks take the last q tile of every head
  const int heads = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / heads;
  const int h = (int)blockIdx.x % heads % H;
  const int b = (int)blockIdx.x % heads / H;
  const int kvh = h / (H / Kv);
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, S - q0);

  // keys any query of this block may see: [k_lo, k_hi), walked in BK tiles
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + q0 + q_rows - 1;
  const int k_lo = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int k_hi = causal ? min(T_len, qp_hi + 1) : T_len;
  const int kt_begin = k_lo / BK;
  const int kt_end = k_hi > k_lo ? (k_hi - 1) / BK + 1 : kt_begin;   // one past the last live tile

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, NTHREADS / 32);   // one arrival per warp
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load(q_s + c * BQ * ROW_BYTES, &q_map, q_full, c * BOX, h, q0, b);
    for (int s = 0; s < STAGES && kt_begin + s < kt_end; ++s)
      load_kv<NC>(&k_map, &v_map, k_s, v_s, k_full, v_full, s, kt_begin + s, kvh, b);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int r0 = WG_ROWS * wg + 16 * (warp % 4) + lane / 4;   // block row of elements 4j, 4j + 1
  const int qp0 = q_offset + q0 + r0;                          // its position; r0 + 8 sits at qp0 + 8
  const int col = 2 * (lane % 4);
  const int wq_lo = q_offset + q0 + WG_ROWS * wg;              // this warpgroup's positions
  const int wq_hi = wq_lo + WG_ROWS - 1;
  const bool use_cap = cap > 0.f;
  const float pre = use_cap ? scale / cap : scale * 1.4426950408889634f;   // on the raw score
  const float post = cap * 1.4426950408889634f;                           // after the tanh
  const int ksteps = (hd + 15) / 16;                           // Q·Kᵀ depth, zero-padded to 16

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {BIG_NEG, BIG_NEG};   // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this thread's share of the running sum

  mbar_wait(q_full, 0);
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int k0 = kt * BK;

    // S = Q·Kᵀ, both K-major; a k-step is 32 bytes into a 128-byte row
    float sc[BK / 2];
    mbar_wait(k_full + 8 * s, phase);
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t qa = q_s + (kk / 4) * BQ * ROW_BYTES + wg * WG_ROWS * ROW_BYTES + (kk % 4) * 32;
      const uint32_t ka = k_s + s * KV_BYTES + (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<BK>(sc, sw128_desc(qa, 16, 8 * ROW_BYTES), sw128_desc(ka, 16, 8 * ROW_BYTES), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale (and softcap) into the log2 domain
    if (use_cap) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = post * tanh_approx(sc[e] * pre);
    } else {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] *= pre;
    }
    // mask only a boundary tile: the diagonal, the window's edge, a ragged T tail
    const bool interior = k0 + BK <= T_len && (!causal || k0 + BK - 1 <= wq_lo) &&
                          (window <= 0 || k0 > wq_hi - window);
    if (!interior) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int kj = k0 + 8 * (e / 4) + col + (e % 2);
        const int qp = qp0 + 8 * ((e / 2) % 2);
        bool ok = kj < T_len;
        if (causal) ok = ok && kj <= qp;
        if (window > 0) ok = ok && kj > qp - window;
        if (!ok) sc[e] = BIG_NEG;
      }
    }

    // online softmax: row max over the quad, the sum kept per thread until the end
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float corr0 = ex2(m[0] - mx0), corr1 = ex2(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - mx0);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - mx0);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - mx1);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - mx1);
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l[0] = l[0] * corr0 + sum0;
    l[1] = l[1] * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }

    // P as the A operand, hi and lo parts: keys 16 kb .. 16 kb + 15 are elements 8 kb .. 8 kb + 7
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_bf16(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1], p_hi[kb][r], p_lo[kb][r]);

    // O += P·V, V MN-major: 16 keys per k-step, 64-column boxes KV rows apart
    mbar_wait(v_full + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      const uint64_t vd = sw128_desc(v_s + s * KV_BYTES + kb * 16 * ROW_BYTES, BK * ROW_BYTES, 8 * ROW_BYTES);
      wgmma_rs<DV>(acc, p_hi[kb], vd);
      wgmma_rs<DV>(acc, p_lo[kb], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) {   // this warp is done with the stage; the last of the 8 refills it
      mbar_arrive(empty + 8 * s);
      if (atomicAdd(&released[s], 1u) % (NTHREADS / 32) == NTHREADS / 32 - 1 && kt + STAGES < kt_end) {
        mbar_wait(empty + 8 * s, phase);
        load_kv<NC>(&k_map, &v_map, k_s, v_s, k_full, v_full, s, kt + STAGES, kvh, b);
      }
    }
  }

  // epilogue: the quad's sums, then acc / max(l, 1e-30) in bf16 for the rows and columns that exist
  float l0 = l[0] + __shfl_xor_sync(FULL, l[0], 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  float l1 = l[1] + __shfl_xor_sync(FULL, l[1], 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int64_t row_stride = (int64_t)H * hd;
  __nv_bfloat16* o0 = o + ((int64_t)b * S + q0 + r0) * row_stride + (int64_t)h * hd;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
  const bool has0 = r0 < q_rows, has1 = r0 + 8 < q_rows;
  if (lse != nullptr && lane % 4 == 0) {   // natural log: (m + log2 l) ln 2, m kept in the log2 domain
    float* lse_row = lse + ((int64_t)b * H + h) * S + q0 + r0;
    if (has0) lse_row[0] = (m[0] + log2f(l0)) * 0.6931471805599453f;
    if (has1) lse_row[8] = (m[1] + log2f(l1)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int c = 8 * j + col;
    if (c >= hd) continue;
    if (has0) *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (has1) *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A [B, L, heads, hd] bf16 tensor as the 4-D map (hd, heads, L, B), boxes of
// (64, 1, rows, 1); L keeps a dimension of its own, so a box that runs past L
// reads zeros, never the next batch row.  fa_tensor_map exports this rule.
void map_geometry(int B, int L, int heads, int hd, int rows, cuuint64_t dims[4], cuuint64_t strides[3],
                  cuuint32_t box[4]) {
  dims[0] = hd, dims[1] = heads, dims[2] = L, dims[3] = B;
  strides[0] = 2ull * hd, strides[1] = 2ull * hd * heads, strides[2] = 2ull * hd * heads * L;  // bytes, dims 1-3
  box[0] = BOX, box[1] = 1, box[2] = rows, box[3] = 1;
}

// The map of map_geometry in the 128-byte swizzle; reads past any dimension are zero.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int L, int heads, int hd, int rows) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  map_geometry(B, L, heads, hd, rows, dims, strides, box);
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                        step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Errors of the host side that are not a cudaError_t (negative, so they never collide).
constexpr int ERR_NO_ENCODE = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -2;      // cuTensorMapEncodeTiled refused a map

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int T_len, int H,
           int Kv, int hd, int causal, int window, float cap, int q_offset, float scale, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return ERR_NO_ENCODE;
  CUtensorMap q_map, k_map, v_map;
  if (make_map(&q_map, q, B, S, H, hd, BQ) != CUDA_SUCCESS ||
      make_map(&k_map, k, B, T_len, Kv, hd, block_kv(NC)) != CUDA_SUCCESS ||
      make_map(&v_map, v, B, T_len, Kv, hd, block_kv(NC)) != CUDA_SUCCESS)
    return ERR_ENCODE;
  const int smem = smem_bytes(NC);
  auto kern = fa_fwd_tc<NC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = (long long)n_qt * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NTHREADS, smem, stream>>>(q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse,
                                                      S, T_len, H, Kv, hd, causal, window, cap, q_offset,
                                                      scale, n_qt);
  return (int)cudaGetLastError();
}

int boxes(int hd) { return (hd + BOX - 1) / BOX; }

int forward(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int T_len, int H,
            int Kv, int hd, int causal, int window, float cap, int q_offset, float scale, cudaStream_t stream) {
  if (hd % 8 != 0) return (int)cudaErrorInvalidValue;   // TMA strides are whole 16 bytes
  switch (boxes(hd)) {
    case 1: return launch<1>(q, k, v, o, lse, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
    case 2: return launch<2>(q, k, v, o, lse, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
    case 3: return launch<3>(q, k, v, o, lse, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
    default: return launch<4>(q, k, v, o, lse, B, S, T_len, H, Kv, hd, causal, window, cap, q_offset, scale, stream);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).  lse:
// null, or f32 [B, H, S] for each row's log-sum-exp.
// Returns 0 when launched, else a cudaError_t or one of tc's negative codes.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                          int T_len, int H, int Kv, int hd, int causal, int window, float softcap,
                          int q_offset, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || hd <= 0 || hd > MAX_HD)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)scalar::forward(q, k, v, o, static_cast<float*>(lse), B, S, T_len, H, Kv, hd, causal, window,
                                softcap, q_offset, scale, st);
  if (dtype == 1)
    return tc::forward(q, k, v, o, static_cast<float*>(lse), B, S, T_len, H, Kv, hd, causal, window, softcap,
                       q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry this library derives for (dtype, hd), for the wrapper to
// hold against its own: {variant (0 scalar, 1 tensor core), hd padded for the
// contraction, 64-column boxes per row, query rows per block, keys per tile,
// threads per block, dynamic shared-memory bytes}.  Returns 0, or
// cudaErrorInvalidValue for a dtype or hd the kernels do not take.
extern "C" int fa_geometry(int dtype, int hd, long long* out) {
  if (hd <= 0 || hd > MAX_HD) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const long long g[7] = {0, hd, 0, scalar::BQ, scalar::BK, scalar::NTHREADS, scalar::smem_bytes(hd)};
    for (int i = 0; i < 7; ++i) out[i] = g[i];
    return 0;
  }
  if (dtype == 1) {
    const int nc = tc::boxes(hd);
    const long long g[7] = {1, (hd + 15) / 16 * 16, nc, tc::BQ, tc::block_kv(nc), tc::NTHREADS, tc::smem_bytes(nc)};
    for (int i = 0; i < 7; ++i) out[i] = g[i];
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor map the tensor-core kernel encodes for a [B, L, heads, hd] bf16
// tensor read in boxes of `rows` rows, for the wrapper to hold against its own:
// {dims (hd, heads, L, B), byte strides of dims 1-3, box (4 numbers)}.
extern "C" void fa_tensor_map(int B, int L, int heads, int hd, int rows, long long* out) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  tc::map_geometry(B, L, heads, hd, rows, dims, strides, box);
  for (int i = 0; i < 4; ++i) out[i] = (long long)dims[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = (long long)strides[i];
  for (int i = 0; i < 4; ++i) out[7 + i] = (long long)box[i];
}

extern "C" const char* fa_error_string(int err) {
  if (err == tc::ERR_NO_ENCODE) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == tc::ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map (address or stride not 16-byte aligned?)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
