// 64-state tail-biting Viterbi decoder (K=7, rate 1/3), sm_90a.
//
// Replaces the TPU Pallas kernel viterbi_regs_pallas / _vit_kernel
// (empower_srslte_tpu/ops/fec/viterbi_pallas.py:146, body :48-143) and
// computes what it computes: the same branch metrics ((l0+l1+l2)/2 etc.
// and their negations), the c1 > c0 selection, subtraction of state 0's
// metric every step, register exchange in ceil(K/32) 32-bit words per
// state, the three segments (circular training halo: metrics only; K
// middle steps: ACS + register shift; flush halo: select, no shift) and
// the first-maximum winner. Decisions are bit-identical to the plain twin
// (ops/fec/convcoder.py viterbi_decode_plain).
//
// Design. One block of 64 threads per code word, one thread per state.
// A step's predecessors of state s are 2(s mod 32) and 2(s mod 32)+1, so
// every thread reads two metrics and two register sets written by other
// threads in the previous step: metrics and registers are double-buffered
// in shared memory with one __syncthreads() per trellis step. Each thread
// also recomputes state 0's new metric (the renormalization constant)
// instead of waiting for thread 0. The 8 branch-metric combinations of
// every column are computed once into shared memory; the circular halo is
// read by index (column (t - halo) mod K), never materialized.
//
// What bounds it. Per step and word ~650 simple operations against 12
// bytes of input: operation- and latency-bound (one barrier per step,
// 2*halo + K dependent steps). At the PDCCH blind search's 4608 words of
// K=55 the whole call is a few microseconds of arithmetic; the launch and
// the step barriers dominate.

#include <cuda_runtime.h>
#include <stdint.h>

#define NSTATES 64
#define MAX_REGS 8

__device__ __forceinline__ int parity7(int x) { return __popc(x) & 1; }

// output bits (G0=133, G1=171, G2=165 octal) of state s under input u,
// packed MSB-first into the branch-metric combination index
__device__ __forceinline__ int out_idx(int s, int u) {
  const int reg = (u << 6) | s;
  return (parity7(reg & 0133) << 2) | (parity7(reg & 0171) << 1) |
         parity7(reg & 0165);
}

__global__ void __launch_bounds__(NSTATES) vit_kernel(
    const float* __restrict__ llr, int* __restrict__ regs_out, int K,
    int halo, int n_regs) {
  extern __shared__ float combs[];  // [K][8]
  __shared__ float m[2][NSTATES];
  __shared__ uint32_t rg[2][MAX_REGS][NSTATES];

  const int s = threadIdx.x;
  const float* x = llr + (size_t)blockIdx.x * 3 * K;
  for (int c = s; c < K; c += NSTATES) {
    const float l0 = x[c], l1 = x[K + c], l2 = x[2 * K + c];
    const float p01 = l0 + l1, m01 = l0 - l1;
    const float c0 = (p01 + l2) * 0.5f, c1 = (p01 - l2) * 0.5f;
    const float c2 = (m01 + l2) * 0.5f, c3 = (m01 - l2) * 0.5f;
    float* cb = combs + (size_t)c * 8;
    cb[0] = c0; cb[1] = c1; cb[2] = c2; cb[3] = c3;
    cb[4] = -c3; cb[5] = -c2; cb[6] = -c1; cb[7] = -c0;
  }
  m[0][s] = 0.0f;
  for (int r = 0; r < MAX_REGS; ++r) { rg[0][r][s] = 0u; rg[1][r][s] = 0u; }

  // wiring of this thread's state and of state 0
  const int pu = s >> 5;
  const int ps0 = (s & 31) << 1, ps1 = ps0 | 1;
  const int i0 = out_idx(ps0, pu), i1 = out_idx(ps1, pu);
  const int z_i0 = out_idx(0, 0), z_i1 = out_idx(1, 0);
  __syncthreads();

  const int steps = 2 * halo + K;
  int cur = 0;
  for (int t = 0; t < steps; ++t) {
    int col = t - halo;
    col = col < 0 ? col + K : (col >= K ? col - K : col);
    const float* cb = combs + (size_t)col * 8;
    const float a0 = m[cur][ps0] + cb[i0];
    const float a1 = m[cur][ps1] + cb[i1];
    const bool best = a1 > a0;
    const float nm = best ? a1 : a0;
    const float z0 = m[cur][0] + cb[z_i0];
    const float z1 = m[cur][1] + cb[z_i1];
    const float n0 = z1 > z0 ? z1 : z0;
    m[cur ^ 1][s] = nm - n0;
    if (t >= halo) {
      const int src = best ? ps1 : ps0;
      if (t < halo + K) {
        uint32_t carry = (uint32_t)pu;
        for (int r = 0; r < n_regs; ++r) {
          const uint32_t v = rg[cur][r][src];
          rg[cur ^ 1][r][s] = (v << 1) | carry;
          carry = v >> 31;
        }
      } else {
        for (int r = 0; r < n_regs; ++r) rg[cur ^ 1][r][s] = rg[cur][r][src];
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  if (s == 0) {
    float best_m = m[cur][0];
    int win = 0;
    for (int q = 1; q < NSTATES; ++q) {
      if (m[cur][q] > best_m) { best_m = m[cur][q]; win = q; }
    }
    for (int r = 0; r < n_regs; ++r)
      regs_out[(size_t)blockIdx.x * n_regs + r] = (int)rg[cur][r][win];
  }
}

extern "C" int viterbi37_launch(const float* llr, int* regs_out, int B, int K,
                                int halo, int n_regs, void* stream) {
  if (n_regs > MAX_REGS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * 8 * sizeof(float);
  vit_kernel<<<B, NSTATES, smem, (cudaStream_t)stream>>>(llr, regs_out, K,
                                                         halo, n_regs);
  return (int)cudaGetLastError();
}
