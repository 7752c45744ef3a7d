// 64-state tail-biting Viterbi decoder (K=7, rate 1/3), sm_90a.
//
// Replaces the TPU Pallas kernel viterbi_regs_pallas / _vit_kernel
// (empower_srslte_tpu/ops/fec/viterbi_pallas.py:146, body :47-143) and
// computes what it computes: the same branch metrics ((l0+l1+l2)/2 etc.
// and their negations), the c1 > c0 selection, subtraction of state 0's
// metric every step, the three segments (circular training halo: metrics
// only; K middle steps; flush halo), the first-maximum winner, and its
// survivor bits packed as ceil(K/32) words with middle decision t at bit
// K-1-t. Decisions are bit-identical to the plain twin
// (ops/fec/convcoder.py viterbi_decode_plain).
//
// What bounds it. Per step and word 64 add-compare-selects (~330 float
// operations) against 12 bytes of input, and 2*halo + K dependent steps:
// operation- and latency-bound. The TPU kernel kept all 64 states of a
// lane in registers, so its butterfly was renaming and no step waited on
// another lane. Here a step costs a warp some 30 instructions for its 64
// states, so the blind search's ~35 warps per SM are bound by instruction
// issue, and the CQI's few warps by the latency of the step chain (the
// shared-memory round trip of the metrics); PERF.md has the times.
//
// Design. One warp per code word, several words per block, no block
// barrier. Lane j holds states j and j+32, which share the predecessors
// 2j and 2j+1: per step it reads both as one 8-byte load from the warp's
// double-buffered 64-float metric array in shared memory, with one
// __syncwarp() between the step's stores and the next step's loads.
// Metrics are stored as computed; the renormalization by state 0's metric
// happens where they are read, (raw[ps] - raw[0]) + comb, the same float32
// subtract and add as the twin's store-then-add, so no lane recomputes
// state 0. The 8 branch-metric combinations of every column are computed
// once into the warp's shared memory (a step loads two of them); the
// circular halo is read by index. Survivors by traceback instead of
// register exchange: each middle and flush step makes two __ballot_sync
// decision words (bit j: state j, resp. j+32, took predecessor 2j+1),
// which lane 0 stores, 8 bytes per step (the training halo stores
// nothing); after the last step a warp reduction finds the winner
// (larger renormalized metric, lower state on ties: the twin's argmax),
// and lane 0 walks the decisions back, through the flush halo and then
// the K middle steps, emitting bit state>>5 of each. Shared memory per
// warp: 512 B metrics, 32*K B combinations, 8*(K+halo) B decisions
// (ops/fec/viterbi37.py vit_plan; the launcher checks the plan's bytes).

#include <cuda_runtime.h>
#include <stdint.h>

#define NSTATES 64
#define MAX_WARPS 4  // vit_plan's WARPS
#define FULL 0xffffffffu

__device__ __forceinline__ int parity7(int x) { return __popc(x) & 1; }

// output bits (G0=133, G1=171, G2=165 octal) of state s under input u,
// packed MSB-first into the branch-metric combination index
__device__ __forceinline__ int out_idx(int s, int u) {
  const int reg = (u << 6) | s;
  return (parity7(reg & 0133) << 2) | (parity7(reg & 0171) << 1) |
         parity7(reg & 0165);
}

static size_t warp_bytes(int K, int halo) {
  return 2 * NSTATES * sizeof(float) + (size_t)K * 8 * sizeof(float) +
         (size_t)(K + halo) * sizeof(uint2);
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

__global__ void __launch_bounds__(32 * MAX_WARPS) vit_kernel(
    const float* __restrict__ llr, int* __restrict__ regs_out, int B, int K,
    int halo, int n_regs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int word = blockIdx.x * warps + wid;
  if (word >= B) return;  // no block barrier anywhere: a warp may leave
  float* met = reinterpret_cast<float*>(smem) + wid * 2 * NSTATES;
  float* combs = reinterpret_cast<float*>(smem + warps * 2 * NSTATES * 4) +
                 (size_t)wid * 8 * K;
  uint2* dec = reinterpret_cast<uint2*>(smem + (size_t)warps *
                                                   (2 * NSTATES * 4 + 32 * K)) +
               (size_t)wid * (K + halo);

  const float* x = llr + (size_t)word * 3 * K;
  for (int c = lane; c < K; c += 32) {
    const float l0 = x[c], l1 = x[K + c], l2 = x[2 * K + c];
    const float p01 = l0 + l1, m01 = l0 - l1;
    const float c0 = (p01 + l2) * 0.5f, c1 = (p01 - l2) * 0.5f;
    const float c2 = (m01 + l2) * 0.5f, c3 = (m01 - l2) * 0.5f;
    float4* cb = reinterpret_cast<float4*>(combs + (size_t)c * 8);
    cb[0] = make_float4(c0, c1, c2, c3);
    cb[1] = make_float4(-c3, -c2, -c1, -c0);
  }
  met[lane] = 0.0f;
  met[lane + 32] = 0.0f;
  // wiring: both states of the lane have predecessors 2*lane, 2*lane + 1
  const int ps0 = lane << 1;
  const int i0 = out_idx(ps0, 0), i1 = out_idx(ps0 | 1, 0);
  __syncwarp();

  float* cur = met;
  float* nxt = met + NSTATES;
  Acs a = {false, false, 0.0f, 0.0f};
  // segment 1: circular training halo (columns K-halo .. K-1), metrics only
  a = run_steps<false>(cur, nxt, combs + (size_t)(K - halo) * 8, halo,
                       nullptr, lane, i0, i1, a);
  // segment 2: the K middle steps; segment 3: the flush halo (columns
  // 0 .. halo-1 again); both keep their decision words
  a = run_steps<true>(cur, nxt, combs, K, dec, lane, i0, i1, a);
  a = run_steps<true>(cur, nxt, combs, halo, dec + K, lane, i0, i1, a);
  const int n_dec = K + halo;

  // winner: first maximum of the renormalized final metrics
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

  // traceback from the winner: the predecessor of s at a step is
  // 2(s mod 32) + its decision bit
  if (lane == 0) {
    int s = bs;
#pragma unroll 4
    for (int t = n_dec - 1; t >= K; --t) {
      const uint2 d = dec[t];
      const unsigned w = (s & 32) ? d.y : d.x;
      s = ((s & 31) << 1) | (int)((w >> (s & 31)) & 1u);
    }
    int* out = regs_out + (size_t)word * n_regs;
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
}

extern "C" int viterbi37_launch(const float* llr, int* regs_out, int B, int K,
                                int halo, int n_regs, int warps, int smem,
                                void* stream) {
  if (K < 1 || halo < 0 || halo > K || n_regs != (K - 1) / 32 + 1 ||
      warps < 1 || warps > MAX_WARPS ||
      (size_t)smem != (size_t)warps * warp_bytes(K, halo))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + warps - 1) / warps;
  vit_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      llr, regs_out, B, K, halo, n_regs);
  return (int)cudaGetLastError();
}
