// NII max-log-MAP constituent decoder for the LTE turbo code, sm_90a.
//
// Replaces the TPU Pallas kernel map_decode_nii / _nii_kernel
// (empower_srslte_tpu/ops/fec/turbo_decoder_pallas2.py:220, body :50-217)
// and computes exactly what it computes, in float32: the same gammas
// ((u+p)/2, (u-p)/2 and their negations), the same max and renormalization
// order (every 16 steps, by the 8-state maximum), the a-priori add at load,
// the NII slot convention of its boundary metrics, `bounds`, and the 3-step
// tail walk of the globally last window.
//
// Design. With NII every window starts from metrics of the previous
// half-iteration, so all (window, code block) pairs are independent: one
// thread per pair, code block fastest, so a warp reads 32 neighbouring
// code blocks of one trellis row (time-major [K, B] arrays, coalesced).
// The 8 alpha or beta metrics live in registers (the trellis wiring is
// constant-folded by full unrolling); the betas of the backward sweep are
// stored per step in a device-memory scratch [l][8][W*B], again thread
// fastest, and read back by the forward sweep.
//
// What bounds it. Per half-iteration and bit it moves 16 bytes the
// function must move (u, p, apr in; ext out) plus 32 bytes of beta stores
// and 32 of beta loads, and issues about 120 float adds/maxes. At 5120
// code blocks of K=5760 that is 0.47 GB of compulsory traffic, 1.9 GB of
// beta traffic and 3.5e9 operations: the beta scratch makes it bound by
// device-memory bandwidth, about 4x above its compulsory-bytes bound.
// Keeping the beta store on chip (shared memory, or recomputation from
// checkpoints) is the next step; not done here.
//
// Built with --fmad=false: every product here is by 0.5 (exact), so FMA
// contraction would not change results, but the flag keeps it certain.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e30f)

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

__device__ __forceinline__ void beta_step(float* beta, float g00, float g01) {
  float nb[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float c0 = beta[tr_ns(s, 0)] + gsel(g00, g01, 0, tr_par(s, 0));
    float c1 = beta[tr_ns(s, 1)] + gsel(g00, g01, 1, tr_par(s, 1));
    nb[s] = fmaxf(c0, c1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = nb[s];
}

__global__ void __launch_bounds__(128) nii_kernel(
    const float* __restrict__ u, const float* __restrict__ p,
    const float* __restrict__ apr, const float* __restrict__ tail_u,
    const float* __restrict__ tail_p, const float* __restrict__ a_st,
    const float* __restrict__ b_st, float* __restrict__ ext,
    float* __restrict__ a_next, float* __restrict__ b_next,
    float* __restrict__ betas, int B, int l, int W, int first_w,
    int last_w) {
  const long long nthr = (long long)W * B;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nthr) return;
  const int b = (int)(tid % B);
  const int w = (int)(tid / B);
  const size_t row0 = (size_t)w * l;

  // ---- beta init: terminated tail walk, or the stored boundary ----
  float beta[8];
  if (w == last_w) {
#pragma unroll
    for (int s = 0; s < 8; ++s) beta[s] = s == 0 ? 0.0f : NEG;
    for (int j = 2; j >= 0; --j) {
      float uu = tail_u[(size_t)j * B + b];
      float pp = tail_p[(size_t)j * B + b];
      beta_step(beta, (uu + pp) * 0.5f, (uu - pp) * 0.5f);
    }
    norm8(beta);
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s)
      beta[s] = b_st[((size_t)(w + 1) * 8 + s) * B + b];
  }

  // ---- backward sweep, storing the beta that enters each step ----
  for (int r = l - 1; r >= 0; --r) {
    const size_t idx = (row0 + r) * B + b;
    float uu = u[idx];
    if (apr != nullptr) uu = uu + apr[idx];
    const float pp = p[idx];
    float* bs = betas + (size_t)r * 8 * nthr + tid;
#pragma unroll
    for (int s = 0; s < 8; ++s) bs[(size_t)s * nthr] = beta[s];
    beta_step(beta, (uu + pp) * 0.5f, (uu - pp) * 0.5f);
    if ((r & 15) == 0) norm8(beta);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    b_next[((size_t)w * 8 + s) * B + b] = beta[s];
    if (w == W - 1) b_next[((size_t)W * 8 + s) * B + b] = 0.0f;
  }

  // ---- forward sweep + extrinsic emission ----
  float alpha[8];
  if (w == first_w) {
#pragma unroll
    for (int s = 0; s < 8; ++s) alpha[s] = s == 0 ? 0.0f : NEG;
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) alpha[s] = a_st[((size_t)w * 8 + s) * B + b];
  }
  for (int r = 0; r < l; ++r) {
    const size_t idx = (row0 + r) * B + b;
    float uu = u[idx];
    if (apr != nullptr) uu = uu + apr[idx];
    const float pp = p[idx];
    const float g00 = (uu + pp) * 0.5f;
    const float g01 = (uu - pp) * 0.5f;
    const float* bs = betas + (size_t)r * 8 * nthr + tid;
    float bk1[8], br0[8], br1[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      bk1[s] = bs[(size_t)s * nthr];
      br0[s] = alpha[s] + gsel(g00, g01, 0, tr_par(s, 0));
      br1[s] = alpha[s] + gsel(g00, g01, 1, tr_par(s, 1));
    }
    float tot0 = br0[0] + bk1[tr_ns(0, 0)];
    float tot1 = br1[0] + bk1[tr_ns(0, 1)];
#pragma unroll
    for (int s = 1; s < 8; ++s) {
      tot0 = fmaxf(tot0, br0[s] + bk1[tr_ns(s, 0)]);
      tot1 = fmaxf(tot1, br1[s] + bk1[tr_ns(s, 1)]);
    }
    ext[idx] = (tot0 - tot1) - uu;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      alpha[s] = fmaxf(br0[tr_ps(s, 0)], br1[tr_ps(s, 1)]);
    if ((r & 15) == 15 || r == l - 1) norm8(alpha);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a_next[((size_t)(w + 1) * 8 + s) * B + b] = alpha[s];
    if (w == 0) a_next[(size_t)s * B + b] = 0.0f;
  }
}

extern "C" int turbo_nii_launch(const float* u, const float* p,
                                const float* apr, const float* tail_u,
                                const float* tail_p, const float* a_st,
                                const float* b_st, float* ext, float* a_next,
                                float* b_next, float* betas, int B, int l,
                                int W, int first_w, int last_w,
                                void* stream) {
  const long long nthr = (long long)W * B;
  const int threads = 128;
  const long long blocks = (nthr + threads - 1) / threads;
  nii_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u, p, apr, tail_u, tail_p, a_st, b_st, ext, a_next, b_next, betas, B,
      l, W, first_w, last_w);
  return (int)cudaGetLastError();
}
