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
// Old states.  S_{t-1} cannot be rebuilt backwards by dividing by w: the model's decays
// come close to 0.  The forward's training form (csrc/wkv6.cu) saves the state before
// every CK = 16 tokens.  For each sub-chunk of SUB = 4 tokens, the last first, this
// kernel recomputes the states forward from its chunk's saved one, keeps the SUB old
// states of its patch in registers, and then sweeps those tokens backwards: 2.5 tokens'
// worth of recomputed states per token (each chunk's first 0, 4, 8 and 12 tokens again,
// plus the sub-chunk's own).
//
// Design.  One block holds one head's whole C x C state and its gradient, so every sum
// stays inside the block: no atomics, and two calls are bitwise equal.  Each thread owns
// a patch of RI rows x JC columns of both (4 x 4 at C = 64: 256 threads, 8 warps).  The
// LC = C / JC lanes that share rows are neighbouring lanes of one warp; their row sums
// (dr, dk and dw: 3 RI SUB per sub-chunk and lane) meet in reduce-scatters of log2 LC
// shuffle steps, after which each lane holds NG finished items and stores them.  dv's
// column sums cross the row groups of a warp by shuffles and the warps through shared
// memory.  Tiles of CK tokens of r, k, v (as stored), w and dout (f32) are staged with
// cp.async, last chunk first, double buffered where that stays under the default 48 KB
// of shared memory (bf16: 36 KB at C = 64; f32 takes one buffer, 28 KB).  A tile's
// prologue computes v_t . dout_t and r_t . (u o k_t) per token and turns tokens past the
// end of the sequence into identities (w = 1; r, k, v and dout are zero-filled).  du is
// summed per block: one partial per batch row and head, which the caller adds up.
//
// Bound.  Per token and head 14 C^2 f32 FLOP: dr, dk, dv and dw one multiply-add per
// element each (8), the dS carry a multiply and a multiply-add (3), and recomputing the
// old state the same (3).  At bf16 B4 S2048 H64 C64 that is 0.449 ms on an H100 SXM at
// 67 TFLOP/s; the bytes (r, k, v, dr, dk, dv in bf16; w, dout, dw and the saved states in
// f32) would take 0.403 ms.
//
// Inputs: r, k, v [B, S, H, C] in f32 or bf16; w [B, S, H, C], u [H, C], s_chk
// [B, H, ceil(S / CK), C, C], dout [B, S, H, C] and ds_fin [B, H, C, C] (optional) in f32.
// Outputs: dr, dk, dv [B, S, H, C] in r's dtype; dw [B, S, H, C], du_part [B, H, C] and
// ds0 [B, H, C, C] in f32.  All contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_common.cuh"  // CK

namespace {

constexpr int SUB = 4;           // tokens whose old states a thread keeps in registers
constexpr int NSUB = CK / SUB;
constexpr float W_MIN = 1e-38f;  // the reference's clamp of w before its log

// Each thread's patch of the state and its gradient, RI rows x JC columns.
template <int C> struct Patch;
template <> struct Patch<64> { static constexpr int RI = 4, JC = 4; };
template <> struct Patch<32> { static constexpr int RI = 2, JC = 4; };
template <> struct Patch<16> { static constexpr int RI = 2, JC = 2; };
template <> struct Patch<8> { static constexpr int RI = 2, JC = 1; };

template <typename T, int C>
struct Geometry {
  static constexpr int RI = Patch<C>::RI, JC = Patch<C>::JC;
  static constexpr int LC = C / JC;           // lanes that share rows, one per column group
  static constexpr int RW = 32 / LC * RI;     // rows of a warp
  static constexpr int NW = C / RW;           // warps of a block
  static constexpr int NT = 32 * NW;
  static constexpr int NITEM = 3 * RI * SUB;  // a lane's row sums of a sub-chunk: dr, dk, dw
  static constexpr int NG = NITEM / LC;       // of which it finishes NG
  static constexpr int LPT = NT / CK;         // prologue: lanes per token ...
  static constexpr int RP = C / LPT;          // ... and channels per lane
  static constexpr int X_BYTES = CK * C * (int)sizeof(T), F_BYTES = CK * C * 4;
  static constexpr int STAGE = 3 * X_BYTES + 2 * F_BYTES;  // r, k, v; w, dout
  static constexpr int DV_BYTES = SUB * NW * C * 4;        // each warp's column sums of dv
  static constexpr int SCALAR_BYTES = 2 * CK * 4;          // v . dout and r . (u o k) per token
  static constexpr int NSTAGE = 2 * STAGE + DV_BYTES + SCALAR_BYTES <= 48 * 1024 ? 2 : 1;
  static constexpr int SMEM = NSTAGE * STAGE + DV_BYTES + SCALAR_BYTES;
  static_assert(LC <= 32 && 32 % LC == 0 && C % RW == 0 && NITEM % LC == 0, "patch");
  static_assert(NT % CK == 0 && LPT <= 32 && RP == 4, "prologue");
  static_assert(SMEM <= 48 * 1024, "within the default shared memory");
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read) when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Rows t0 .. t0 + CK - 1 of one (batch, head) slice, C elements each, into dst[CK][C];
// src + base + t * stride is row t.  Rows at or past seq are zero-filled.
template <int C, int NT, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, size_t base, size_t stride, int t0, int seq,
                                           int tid) {
  constexpr int PER = 16 / (int)sizeof(E), CH = C / PER;  // elements per chunk, chunks per row
  static_assert(CH * PER == C, "rows are whole 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (CK * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT, t = e / CH, q = e % CH;
    const bool in = t0 + t < seq;
    if (e < CK * CH)
      cp_async16(dst + t * C + q * PER, src + (in ? base + (size_t)(t0 + t) * stride + q * PER : 0), in);
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

// A lane's row sum q (0: dr, 1: dk, 2: dw) of row a and sub-chunk token i: item
// (q RI + a) SUB + i, kept at p[item / LC][item % LC] until the reduce-scatter.
template <int RI>
__host__ __device__ constexpr int item_of(int q, int a, int i) { return (q * RI + a) * SUB + i; }

template <typename T, int C>
__global__ void __launch_bounds__(Geometry<T, C>::NT, 1) wkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s_chk,
    const float* __restrict__ dout, const float* __restrict__ ds_fin, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ ds0, int seq, int H) {
  using Gm = Geometry<T, C>;
  constexpr int RI = Gm::RI, JC = Gm::JC, LC = Gm::LC, NW = Gm::NW, NT = Gm::NT, NG = Gm::NG;
  constexpr int LPT = Gm::LPT, RP = Gm::RP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dv_sums = reinterpret_cast<float*>(smem + Gm::NSTAGE * Gm::STAGE);  // [SUB][NW][C]
  float* vdot = dv_sums + SUB * NW * C;   // v_t . dout_t of the tile's tokens
  float* bonus = vdot + CK;               // r_t . (u o k_t)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, lc = lane % LC;
  const int row0 = warp * Gm::RW + lane / LC * RI;  // this thread's rows row0 .. row0 + RI - 1
  const int col0 = lc * JC;                          // and columns col0 .. col0 + JC - 1
  const size_t stride = (size_t)H * C;               // between tokens
  const size_t base = (size_t)b * seq * stride + (size_t)h * C;  // (b, t = 0, h, 0)
  const size_t state_base = ((size_t)b * H + h) * C * C;
  const int nchunk = (seq + CK - 1) / CK;
  const float* chk = s_chk + state_base * nchunk;    // this head's saved states [nchunk][C][C]

  // the prologue's share: LPT lanes per token, RP channels each, u of those channels
  const int tp = tid / LPT, prow = tid % LPT * RP;
  float up[RP];
  load(u + h * C + prow, up);

  float ds[RI][JC];
  const bool has_dsfin = ds_fin != nullptr;
#pragma unroll
  for (int a = 0; a < RI; ++a) {
    if (has_dsfin) {
      load(ds_fin + state_base + (size_t)(row0 + a) * C + col0, ds[a]);
    } else {
#pragma unroll
      for (int c = 0; c < JC; ++c) ds[a][c] = 0.f;
    }
  }
  float du_acc = 0.f;  // du of channel tid, for tid < C

  auto tile_ptrs = [&](int q, T*& rs, T*& ks, T*& vs, float*& ws, float*& dos) {
    unsigned char* p = smem + q % Gm::NSTAGE * Gm::STAGE;
    rs = reinterpret_cast<T*>(p);
    ks = reinterpret_cast<T*>(p + Gm::X_BYTES);
    vs = reinterpret_cast<T*>(p + 2 * Gm::X_BYTES);
    ws = reinterpret_cast<float*>(p + 3 * Gm::X_BYTES);
    dos = reinterpret_cast<float*>(p + 3 * Gm::X_BYTES + Gm::F_BYTES);
  };
  auto stage = [&](int q) {  // tile q holds chunk nchunk - 1 - q; one cp.async group, empty past the end
    if (q < nchunk) {
      T *rs, *ks, *vs;
      float *ws, *dos;
      tile_ptrs(q, rs, ks, vs, ws, dos);
      const int t0 = (nchunk - 1 - q) * CK;
      stage_rows<C, NT>(rs, r, base, stride, t0, seq, tid);
      stage_rows<C, NT>(ks, k, base, stride, t0, seq, tid);
      stage_rows<C, NT>(vs, v, base, stride, t0, seq, tid);
      stage_rows<C, NT>(ws, w, base, stride, t0, seq, tid);
      stage_rows<C, NT>(dos, dout, base, stride, t0, seq, tid);
    }
    cp_async_commit();
  };

  if constexpr (Gm::NSTAGE > 1) stage(0);
  for (int q = 0; q < nchunk; ++q) {
    const int c = nchunk - 1 - q, t0 = c * CK, n = min(CK, seq - t0);
    if constexpr (Gm::NSTAGE > 1) {
      cp_async_wait_all();
      __syncthreads();  // this tile has landed, and every thread is done with the previous one
      stage(q + 1);     // into the buffer the previous tile used
    } else {
      stage(q);
      cp_async_wait_all();
      __syncthreads();
    }
    T *rs, *ks, *vs;
    float *ws, *dos;
    tile_ptrs(q, rs, ks, vs, ws, dos);

    // Prologue: v_t . dout_t and r_t . (u o k_t), LPT lanes per token; tokens past seq become identities.
    {
      float rr[RP], kk[RP], vv[RP], dd[RP];
      load(rs + tp * C + prow, rr);
      load(ks + tp * C + prow, kk);
      load(vs + tp * C + prow, vv);
      load(dos + tp * C + prow, dd);
      float ab = 0.f, av = 0.f;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        ab = fmaf(rr[i], up[i] * kk[i], ab);
        av = fmaf(vv[i], dd[i], av);
      }
#pragma unroll
      for (int d = LPT / 2; d >= 1; d /= 2) {
        ab += __shfl_xor_sync(0xffffffffu, ab, d);
        av += __shfl_xor_sync(0xffffffffu, av, d);
      }
      if (tid % LPT == 0) bonus[tp] = ab, vdot[tp] = av;
      if (tp >= n) {
#pragma unroll
        for (int i = 0; i < RP; ++i) ws[tp * C + prow + i] = 1.f;
      }
    }
    __syncthreads();
    if (tid < C) {
      for (int t = 0; t < n; ++t) du_acc = fmaf(to_f32(rs[t * C + tid]) * to_f32(ks[t * C + tid]), vdot[t], du_acc);
    }

    // S <- w o S + k (x) v for this thread's patch, token t of the tile
    auto step_state = [&](int t, float (&st)[RI][JC]) {
      float kk[RI], ww[RI], vv[JC];
      load(ks + t * C + row0, kk);
      load(ws + t * C + row0, ww);
      load(vs + t * C + col0, vv);
#pragma unroll
      for (int a = 0; a < RI; ++a) {
#pragma unroll
        for (int j = 0; j < JC; ++j) st[a][j] = fmaf(ww[a], st[a][j], kk[a] * vv[j]);
      }
    };

    const float* chunk_state = chk + (size_t)c * C * C;  // the state before token t0
    for (int s = NSUB - 1; s >= 0; --s) {
      const int ts0 = s * SUB;  // the sub-chunk's first token in the tile
      float old[SUB][RI][JC];
      {
        float st[RI][JC];
#pragma unroll
        for (int a = 0; a < RI; ++a) load(chunk_state + (size_t)(row0 + a) * C + col0, st[a]);
        for (int t = 0; t < ts0; ++t) step_state(t, st);
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
#pragma unroll
          for (int a = 0; a < RI; ++a) {
#pragma unroll
            for (int j = 0; j < JC; ++j) old[i][a][j] = st[a][j];
          }
          if (i < SUB - 1) step_state(ts0 + i, st);
        }
      }

      // The sub-chunk's tokens backwards: row sums into p, dv's column sums into shared memory, the dS carry.
      float p[NG][LC];
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        const int t = ts0 + i;
        float rr[RI], kk[RI], ww[RI], vv[JC], dd[JC];
        load(rs + t * C + row0, rr);
        load(ks + t * C + row0, kk);
        load(ws + t * C + row0, ww);
        load(vs + t * C + col0, vv);
        load(dos + t * C + col0, dd);
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            pr = fmaf(old[i][a][j], dd[j], pr);
            pk = fmaf(ds[a][j], vv[j], pk);
            pw = fmaf(ds[a][j], old[i][a][j], pw);
          }
          p[item_of<RI>(0, a, i) / LC][item_of<RI>(0, a, i) % LC] = pr;
          p[item_of<RI>(1, a, i) / LC][item_of<RI>(1, a, i) % LC] = pk;
          p[item_of<RI>(2, a, i) / LC][item_of<RI>(2, a, i) % LC] = pw;
        }
        float pv[JC];
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          pv[j] = 0.f;
#pragma unroll
          for (int a = 0; a < RI; ++a) pv[j] = fmaf(ds[a][j], kk[a], pv[j]);
#pragma unroll
          for (int d = LC; d < 32; d *= 2) pv[j] += __shfl_xor_sync(0xffffffffu, pv[j], d);
        }
        if (lane < LC) {
#pragma unroll
          for (int j = 0; j < JC; ++j) dv_sums[(i * NW + warp) * C + col0 + j] = pv[j];
        }
#pragma unroll
        for (int a = 0; a < RI; ++a) {
#pragma unroll
          for (int j = 0; j < JC; ++j) ds[a][j] = fmaf(ww[a], ds[a][j], rr[a] * dd[j]);
        }
      }

      // Row sums: each lane finishes items g LC + lc and stores them with their bonus terms.
#pragma unroll
      for (int g = 0; g < NG; ++g) reduce_scatter<LC / 2>(p[g], lane);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int item = g * LC + lc, which = item / (RI * SUB), a = item / SUB % RI, i = item % SUB;
        const int t = ts0 + i, row = row0 + a;
        if (t < n) {
          const size_t o = base + (size_t)(t0 + t) * stride + row;
          const float sum = p[g][0], ur = u[h * C + row], rt = to_f32(rs[t * C + row]), kt = to_f32(ks[t * C + row]);
          if (which == 0) {
            store(dr + o, sum + ur * kt * vdot[t]);
          } else if (which == 1) {
            store(dk + o, sum + rt * ur * vdot[t]);
          } else {
            dw[o] = ws[t * C + row] > W_MIN ? sum : 0.f;
          }
        }
      }
      __syncthreads();  // every warp's dv sums are in
      for (int e = tid; e < SUB * C; e += NT) {
        const int i = e / C, j = e % C, t = ts0 + i;
        float acc = 0.f;
#pragma unroll
        for (int wi = 0; wi < NW; ++wi) acc += dv_sums[(i * NW + wi) * C + j];
        if (t < n) store(dv + base + (size_t)(t0 + t) * stride + j, acc + bonus[t] * dos[t * C + j]);
      }
      __syncthreads();  // dv_sums is free again
    }
  }

#pragma unroll
  for (int a = 0; a < RI; ++a) {
#pragma unroll
    for (int j = 0; j < JC; ++j) ds0[state_base + (size_t)(row0 + a) * C + col0 + j] = ds[a][j];
  }
  if (tid < C) du_part[((size_t)b * H + h) * C + tid] = du_acc;
}

template <typename T, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s_chk, const float* dout, const float* ds_fin, void* dr, void* dk, void* dv,
                   float* dw, float* du_part, float* ds0, int B, int seq, int H, cudaStream_t stream) {
  using Gm = Geometry<T, C>;
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
