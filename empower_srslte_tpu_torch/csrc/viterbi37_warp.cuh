// One warp's 64-state tail-biting Viterbi (K=7, rate 1/3): the trellis
// step, the winner and the traceback that csrc/viterbi37.cu (one warp per
// code word) and csrc/pdcch_rx.cu (one warp per blind-search candidate)
// both run. Everything here is inlined into its kernel; the arithmetic is
// the plain twin's (ops/fec/convcoder.py viterbi_decode_plain), operation
// for operation, so the decisions are bit-identical to it.
//
// Lane j holds states j and j+32, which share the predecessors 2j and
// 2j+1. A step reads both as one 8-byte load from the warp's
// double-buffered 64-float metric array in shared memory; the caller syncs
// the warp between a step's stores and the next step's loads. Metrics are
// stored as computed; the renormalization by state 0's metric happens where
// they are read, (raw[ps] - raw[0]) + comb, the same float32 subtract and
// add as the twin's store-then-add. Each column's 8 branch-metric
// combinations sit in shared memory (vit_combs); a middle or flush step
// makes two ballot decision words (bit j: state j, resp. j+32, took
// predecessor 2j+1), which lane 0 stores, 8 bytes per step.

#ifndef VITERBI37_WARP_CUH
#define VITERBI37_WARP_CUH

#include <cuda_runtime.h>
#include <stdint.h>

#define NSTATES 64
#define FULL 0xffffffffu

__device__ __forceinline__ int parity7(int x) { return __popc(x) & 1; }

// output bits (G0=133, G1=171, G2=165 octal) of state s under input u,
// packed MSB-first into the branch-metric combination index
__device__ __forceinline__ int out_idx(int s, int u) {
  const int reg = (u << 6) | s;
  return (parity7(reg & 0133) << 2) | (parity7(reg & 0171) << 1) |
         parity7(reg & 0165);
}

// the 8 branch-metric combinations of one column (l0, l1, l2), as the
// twin's metric_step forms them, at cb[0..7]: (l0+l1+l2)/2 ... and their
// negations in reverse order (cb[7-i] == -cb[i] exactly)
__device__ __forceinline__ void vit_combs(float* cb, float l0, float l1,
                                          float l2) {
  const float p01 = l0 + l1, m01 = l0 - l1;
  const float c0 = (p01 + l2) * 0.5f, c1 = (p01 - l2) * 0.5f;
  const float c2 = (m01 + l2) * 0.5f, c3 = (m01 - l2) * 0.5f;
  float4* cb4 = reinterpret_cast<float4*>(cb);
  cb4[0] = make_float4(c0, c1, c2, c3);
  cb4[1] = make_float4(-c3, -c2, -c1, -c0);
}

// One trellis step of the warp: lane states s = lane (lo) and lane + 32
// (hi). Reads the raw metrics of step t-1 from `cur`, writes its own raw
// metrics to `nxt`; the caller syncs the warp before the next step. All
// three generators tap the input bit, so state s+32's combination index is
// 7 minus state s's, and the stored combinations satisfy cb[7-i] == -cb[i]
// exactly: m + cb[7-i] is the same float32 as m - cb[i], one load fewer.
struct Acs {
  bool d_lo, d_hi;
  float n_lo, n_hi;
};

__device__ __forceinline__ Acs acs_step(const float* __restrict__ cur,
                                        float* __restrict__ nxt,
                                        const float* __restrict__ cb,
                                        int lane, int i0, int i1) {
  const float2 pm = reinterpret_cast<const float2*>(cur)[lane];
  const float r0 = cur[0];
  const float m0 = pm.x - r0, m1 = pm.y - r0;
  const float c0 = cb[i0], c1 = cb[i1];
  const float a0 = m0 + c0, a1 = m1 + c1;
  const float b0 = m0 - c0, b1 = m1 - c1;
  Acs r;
  r.d_lo = a1 > a0;
  r.d_hi = b1 > b0;
  r.n_lo = r.d_lo ? a1 : a0;
  r.n_hi = r.d_hi ? b1 : b0;
  nxt[lane] = r.n_lo;
  nxt[lane + 32] = r.n_hi;
  return r;
}

// `n` steps over consecutive columns from `cb`, swapping the metric
// buffers after each; with KEEP, lane 0 stores each step's two ballot
// words (bit j: state j, resp. j+32, took predecessor 2j+1) to dec[t].
// Returns the last step's result (`a` when n is 0).
template <bool KEEP>
__device__ __forceinline__ Acs run_steps(float*& cur, float*& nxt,
                                         const float* __restrict__ cb, int n,
                                         uint2* __restrict__ dec, int lane,
                                         int i0, int i1, Acs a) {
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    a = acs_step(cur, nxt, cb + (size_t)t * 8, lane, i0, i1);
    if (KEEP) {
      const unsigned lo = __ballot_sync(FULL, a.d_lo);
      const unsigned hi = __ballot_sync(FULL, a.d_hi);
      if (lane == 0) dec[t] = make_uint2(lo, hi);
    }
    __syncwarp();
    float* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return a;
}

// The winner of the last step `a`, on every lane: the first maximum of the
// renormalized final metrics (larger metric, lower state on ties: the
// twin's argmax).
__device__ __forceinline__ int vit_winner(const Acs& a, int lane) {
  const float r0 = __shfl_sync(FULL, a.n_lo, 0);
  const float m_lo = a.n_lo - r0, m_hi = a.n_hi - r0;
  float bm = m_lo;
  int bs = lane;
  if (m_hi > bm) { bm = m_hi; bs = lane + 32; }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float om = __shfl_xor_sync(FULL, bm, off);
    const int os = __shfl_xor_sync(FULL, bs, off);
    if (om > bm || (om == bm && os < bs)) { bm = om; bs = os; }
  }
  return bs;
}

// Lane 0's traceback from the winner `s` over the n_dec = K + halo stored
// decision words (the predecessor of s at a step is 2(s mod 32) + its
// decision bit): through the flush halo, then the K middle steps, packing
// middle step K-1-p's bit (state >> 5) at bit p of out[p >> 5], the twin's
// winner registers.
__device__ __forceinline__ void vit_traceback(const uint2* dec, int K,
                                              int n_dec, int s, int* out) {
#pragma unroll 4
  for (int t = n_dec - 1; t >= K; --t) {
    const uint2 d = dec[t];
    const unsigned w = (s & 32) ? d.y : d.x;
    s = ((s & 31) << 1) | (int)((w >> (s & 31)) & 1u);
  }
  unsigned acc = 0u;
#pragma unroll 4
  for (int p = 0; p < K; ++p) {  // middle step K-1-p sits at bit p
    const uint2 d = dec[K - 1 - p];
    acc |= (unsigned)(s >> 5) << (p & 31);
    const unsigned w = (s & 32) ? d.y : d.x;
    s = ((s & 31) << 1) | (int)((w >> (s & 31)) & 1u);
    if ((p & 31) == 31 || p == K - 1) {
      out[p >> 5] = (int)acc;
      acc = 0u;
    }
  }
}

#endif  // VITERBI37_WARP_CUH
