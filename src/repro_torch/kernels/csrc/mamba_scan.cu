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
// Layout.  The TPU kernel walks time chunks as the sequential grid dimension
// with the [bd, ds] state in VMEM; here one block owns CB = 32 channels of one
// batch row for the whole sequence (the last block of a ragged di masks the
// rest), the time loop runs inside the block, and the state lives in f32
// registers.  At B = 1, di = 8192 one thread per channel would give 8,192
// threads, under half a warp for each of the card's 528 schedulers, so the ds
// states of a channel are split over LANES = 4 neighbouring lanes (ds / 4
// states each, 32,768 threads, two warps per scheduler) and the lanes' partial
// y meet through two xor-shuffles.  A tile of TT = 32 tokens is staged in
// shared memory: u and delta of the block's channels (coalesced 128-byte rows)
// and B, C (ds floats each, shared by every channel of the block, so they are
// read once per block and tile).  The next tile is fetched into registers
// while the current one is computed.  y is collected in shared memory and
// written out coalesced once per tile.
//
// Bound.  Per token and channel the scan reads u and delta and writes y,
// 12 bytes in f32, and does ds exponentials and about 4 ds other f32
// operations.  At ds = 16 the exponentials on the special-function units (16
// per SM per clock) take about as long as the bytes at 3.35 TB/s, so the two
// bound it about equally (chip_smoke.py computes both).  This version uses
// the accurate expf, a few instructions around one MUFU.EX2.
//
// Inputs, all float32 and contiguous: u, delta [B, S, di]; A [di, ds];
// B, C [B, S, ds]; h0 [B, di, ds] (optional).  Outputs, float32: y [B, S, di]
// and h_fin [B, di, ds].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4;          // lanes that share one channel's states
constexpr int CB = 32;            // channels per block
constexpr int NT = CB * LANES;    // threads per block
constexpr int TT = 32;            // tokens staged in shared memory at a time
constexpr int PER_UD = TT * CB / NT;  // u (and delta) elements each thread stages per tile

template <int DS>
__global__ void __launch_bounds__(NT) mamba_scan_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_fin, int seq, int di) {
  constexpr int NS = DS / LANES;                  // states per thread
  constexpr int PER_BC = (TT * DS + NT - 1) / NT;  // B (and C) elements each thread stages per tile
  __shared__ float us[TT][CB];
  __shared__ float dts[TT][CB];
  __shared__ float ys[TT][CB];
  __shared__ float bs[TT][DS];
  __shared__ float cs[TT][DS];

  const int tid = threadIdx.x;
  const int cl = tid / LANES, lane = tid % LANES;
  const int b = blockIdx.y, ch0 = blockIdx.x * CB;
  const int ch = ch0 + cl;  // the channel this thread owns, at states lane * NS .. lane * NS + NS - 1
  const bool live = ch < di;  // the last block's channels past di compute on zeros and store nothing
  const size_t state_base = ((size_t)b * di + ch) * DS + lane * NS;

  float a[NS], h[NS];
  const bool has_h0 = h0 != nullptr;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = live ? A[(size_t)ch * DS + lane * NS + n] : 0.f;
    h[n] = live && has_h0 ? h0[state_base + n] : 0.f;
  }

  // The next tile: u, delta element e = tid + p NT is token e / CB, channel ch0 + e % CB;
  // B, C element e is token e / DS, state e % DS (a tile of B or C is contiguous).
  float nu[PER_UD], nd[PER_UD], nb[PER_BC], nc[PER_BC];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int p = 0; p < PER_UD; ++p) {
      const int e = tid + p * NT, tt = e / CB;
      if (t0 + tt < seq) {
        const bool in = ch0 + e % CB < di;
        const size_t g = ((size_t)b * seq + t0 + tt) * di + ch0 + e % CB;
        nu[p] = in ? u[g] : 0.f;
        nd[p] = in ? delta[g] : 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < PER_BC; ++p) {
      const int e = tid + p * NT;
      if (e < TT * DS && t0 + e / DS < seq) {
        const size_t g = ((size_t)b * seq + t0) * DS + e;
        nb[p] = Bm[g];
        nc[p] = Cm[g];
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < seq; t0 += TT) {
    const int n = min(TT, seq - t0);
#pragma unroll
    for (int p = 0; p < PER_UD; ++p) {
      const int e = tid + p * NT;
      if (e / CB < n) {
        us[e / CB][e % CB] = nu[p];
        dts[e / CB][e % CB] = nd[p];
      }
    }
#pragma unroll
    for (int p = 0; p < PER_BC; ++p) {
      const int e = tid + p * NT;
      if (e < TT * DS && e / DS < n) {
        bs[e / DS][e % DS] = nb[p];
        cs[e / DS][e % DS] = nc[p];
      }
    }
    __syncthreads();
    if (t0 + TT < seq) fetch(t0 + TT);  // in flight while this tile is computed
    for (int tt = 0; tt < n; ++tt) {
      const float dt = dts[tt][cl];
      const float du = dt * us[tt][cl];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float decay = expf(dt * a[s]);
        h[s] = fmaf(decay, h[s], du * bs[tt][lane * NS + s]);
        acc = fmaf(h[s], cs[tt][lane * NS + s], acc);
      }
#pragma unroll
      for (int off = 1; off < LANES; off *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) ys[tt][cl] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n * CB; e += NT) {
      if (ch0 + e % CB < di) y[((size_t)b * seq + t0 + e / CB) * di + ch0 + e % CB] = ys[e / CB][e % CB];
    }
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s) h_fin[state_base + s] = h[s];
  }
}

template <int DS>
cudaError_t launch(const float* u, const float* delta, const float* A, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* h_fin, int batch, int seq,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + CB - 1) / CB, batch);
  mamba_scan_kernel<DS><<<grid, NT, 0, stream>>>(u, delta, A, Bm, Cm, h0, y, h_fin, seq, di);
  return cudaGetLastError();
}

}  // namespace

// ds must be 4, 8, 16 or 32; h0 may be null (zero state).
// Returns a cudaError_t (0 = launched).
extern "C" int mamba_scan_forward(const void* u, const void* delta, const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y, void* h_fin, int batch,
                                  int S, int di, int ds, void* stream) {
  if (batch <= 0 || S <= 0 || di <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
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
    case 4: return (int)launch<4>(uf, df, af, bf, cf, hf, yf, ff, batch, S, di, st);
    case 8: return (int)launch<8>(uf, df, af, bf, cf, hf, yf, ff, batch, S, di, st);
    case 16: return (int)launch<16>(uf, df, af, bf, cf, hf, yf, ff, batch, S, di, st);
    case 32: return (int)launch<32>(uf, df, af, bf, cf, hf, yf, ff, batch, S, di, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
