// Windowed-overlap max-log-MAP constituent decoder for the LTE turbo code,
// sm_90a.
//
// Replaces the TPU Pallas kernel map_decode_fused / _half_iter_kernel
// (empower_srslte_tpu/ops/fec/turbo_decoder_pallas.py:196, body :62-193)
// and computes exactly what it computes, in float32: one constituent
// decode of K payload steps cut into W = K/L windows; each window trains
// alpha over the O steps before it and beta over the O steps after it,
// from uniform metrics, except window 0's alpha and the last window's beta,
// which start from the exact metric {0, -1e30 x 7}. Rows outside the
// trellis [0, K+3) are padding: systematic/a-priori rows read as PAD_LLR
// (1e5, in the pre-halved domain) and parity rows as 0. Real rows are
// halved at load (exact). Gammas g00 = ls + lp, g01 = ls - lp and their
// negations; both sweeps renormalize once per 8-step group by the 8-state
// maximum; the beta sweep stores the carry entering each step; the alpha
// sweep emits llr = max_s(a + g(0) + b_ns0) - max_s(a + g(1) + b_ns1).
//
// Design. Every (window, code block) pair is independent, so one thread
// per pair, code block fastest: a warp reads 32 neighbouring code blocks
// of one trellis row of the time-major [K+3, B] inputs (coalesced). The
// padding is never materialized: the thread maps its row to the trellis
// and substitutes the pad values by index. The 8 alpha or beta metrics
// live in registers (the trellis wiring is constant-folded by unrolling);
// the betas of the backward sweep go to a device-memory scratch
// [L][8][W*B], thread fastest, read back by the forward sweep.
//
// What bounds it. The compulsory traffic is lsa and lp read once and llr
// written once: 12 bytes per bit. Per window it does about 100 float
// operations per step over L+O steps. The beta scratch adds 64 bytes per
// bit (32 stored, 32 loaded), and each window re-reads its 2O overlap
// rows, so it is bound by device-memory bandwidth well above its
// compulsory-bytes bound; at the 20 MHz uplink (1792 code blocks of
// K=5824, 26 windows) there are only 46592 threads, so latency of the
// serial recursion matters too. Keeping the beta store on chip is the
// next step; not done here.
//
// Built with --fmad=false: every product here is by 0.5 (exact).

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e30f)
#define PAD_LLR (1e5f)
#define GROUP 8

// LTE RSC trellis, state s = (r1 << 2) | (r2 << 1) | r3
// (empower_srslte_tpu_torch/ops/fec/turbo_encoder.py TurboTrellis).
__device__ __forceinline__ int tr_ns(int s, int u) {
  int r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
  int a = u ^ r2 ^ r3;
  return (a << 2) | (r1 << 1) | r2;
}
__device__ __forceinline__ int tr_par(int s, int u) {
  int r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
  int a = u ^ r2 ^ r3;
  return a ^ r1 ^ r3;
}
// predecessor of state sp under input u
__device__ __forceinline__ int tr_ps(int sp, int u) {
  int a = (sp >> 2) & 1, r1 = (sp >> 1) & 1, r2 = sp & 1;
  int r3 = a ^ u ^ r2;
  return (r1 << 2) | (r2 << 1) | r3;
}

// branch metric g(u, parity): g00, g01, -g01, -g00
__device__ __forceinline__ float gsel(float g00, float g01, int u, int par) {
  return u == 0 ? (par == 0 ? g00 : g01) : (par == 0 ? -g01 : -g00);
}

__device__ __forceinline__ void norm8(float* v) {
  float m = v[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) m = fmaxf(m, v[s]);
#pragma unroll
  for (int s = 0; s < 8; ++s) v[s] = v[s] - m;
}

// halved (ls, lp) of trellis row t for code block b; padding by index
__device__ __forceinline__ void load_row(const float* __restrict__ lsa,
                                         const float* __restrict__ lp,
                                         long long t, int rows, int B, int b,
                                         float* ls, float* lq) {
  if (t < 0 || t >= rows) {
    *ls = PAD_LLR;
    *lq = 0.0f;
  } else {
    const size_t idx = (size_t)t * B + b;
    *ls = lsa[idx] * 0.5f;
    *lq = lp[idx] * 0.5f;
  }
}

__global__ void __launch_bounds__(64) win_kernel(
    const float* __restrict__ lsa, const float* __restrict__ lp,
    float* __restrict__ llr, float* __restrict__ betas, int B, int K, int L,
    int O) {
  const int W = K / L;
  const long long nthr = (long long)W * B;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nthr) return;
  const int b = (int)(tid % B);
  const int w = (int)(tid / B);
  const int rows = K + 3;
  // trellis row of the window's local step i (alpha: i in [0, L+O) is row
  // w*L - O + i; beta: local step i in [0, L+O) is row w*L + i)
  const long long row0 = (long long)w * L;

  // ---- beta backward sweep, storing the carry entering each step ----
  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = (w == W - 1 && s != 0) ? NEG : 0.0f;
  for (int i = L + O - 1; i >= 0; --i) {
    float ls, lq;
    load_row(lsa, lp, row0 + i, rows, B, b, &ls, &lq);
    const float g00 = ls + lq;
    const float g01 = ls - lq;
    if (i < L) {
      float* bs = betas + (size_t)i * 8 * nthr + tid;
#pragma unroll
      for (int s = 0; s < 8; ++s) bs[(size_t)s * nthr] = beta[s];
    }
    float nb[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float c0 = beta[tr_ns(s, 0)] + gsel(g00, g01, 0, tr_par(s, 0));
      float c1 = beta[tr_ns(s, 1)] + gsel(g00, g01, 1, tr_par(s, 1));
      nb[s] = fmaxf(c0, c1);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) beta[s] = nb[s];
    if ((i & (GROUP - 1)) == 0) norm8(beta);
  }

  // ---- alpha forward sweep: O training steps, then L emit steps ----
  float alpha[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) alpha[s] = (w == 0 && s != 0) ? NEG : 0.0f;
  for (int i = 0; i < L + O; ++i) {
    float ls, lq;
    load_row(lsa, lp, row0 - O + i, rows, B, b, &ls, &lq);
    const float g00 = ls + lq;
    const float g01 = ls - lq;
    float br0[8], br1[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      br0[s] = alpha[s] + gsel(g00, g01, 0, tr_par(s, 0));
      br1[s] = alpha[s] + gsel(g00, g01, 1, tr_par(s, 1));
    }
    if (i >= O) {
      const float* bs = betas + (size_t)(i - O) * 8 * nthr + tid;
      float bk1[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) bk1[s] = bs[(size_t)s * nthr];
      float tot0 = br0[0] + bk1[tr_ns(0, 0)];
      float tot1 = br1[0] + bk1[tr_ns(0, 1)];
#pragma unroll
      for (int s = 1; s < 8; ++s) {
        tot0 = fmaxf(tot0, br0[s] + bk1[tr_ns(s, 0)]);
        tot1 = fmaxf(tot1, br1[s] + bk1[tr_ns(s, 1)]);
      }
      llr[(size_t)(row0 + i - O) * B + b] = tot0 - tot1;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s)
      alpha[s] = fmaxf(br0[tr_ps(s, 0)], br1[tr_ps(s, 1)]);
    if ((i & (GROUP - 1)) == GROUP - 1) norm8(alpha);
  }
}

extern "C" int turbo_win_launch(const float* lsa, const float* lp,
                                float* llr, float* betas, int B, int K,
                                int L, int O, void* stream) {
  const long long nthr = (long long)(K / L) * B;
  const int threads = 64;
  const long long blocks = (nthr + threads - 1) / threads;
  win_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      lsa, lp, llr, betas, B, K, L, O);
  return (int)cudaGetLastError();
}
