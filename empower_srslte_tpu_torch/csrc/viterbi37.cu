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
// The warp's step, winner and traceback are viterbi37_warp.cuh's, which
// the PDCCH blind search (pdcch_rx.cu) runs too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi37_warp.cuh"

#define MAX_WARPS 4  // vit_plan's WARPS

static size_t warp_bytes(int K, int halo) {
  return 2 * NSTATES * sizeof(float) + (size_t)K * 8 * sizeof(float) +
         (size_t)(K + halo) * sizeof(uint2);
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
  for (int c = lane; c < K; c += 32)
    vit_combs(combs + (size_t)c * 8, x[c], x[K + c], x[2 * K + c]);
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

  // the winner, and lane 0's traceback into the word's registers
  const int bs = vit_winner(a, lane);
  if (lane == 0)
    vit_traceback(dec, K, n_dec, bs, regs_out + (size_t)word * n_regs);
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
