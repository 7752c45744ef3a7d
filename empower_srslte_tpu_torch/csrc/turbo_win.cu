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
// maximum; the beta sweep's stored carry is the one entering each step;
// the alpha sweep emits llr = max_s(a + g(0) + b_ns0) - max_s(a + g(1) +
// b_ns1).
//
// Design. Every (window, code block) pair is independent, so one thread
// per pair; a block is one warp of 32 neighbouring code blocks of one
// window, so a trellis row of the time-major [K+3, B] inputs is one
// coalesced 128-byte line. The 8 alpha or beta metrics live in registers.
//
// * Phase A interleaves the two independent training recursions: each of
//   the O steps does one beta step (rows wL+L+O-1 down to wL+L) and one
//   alpha step (rows wL-O up to wL-1), two dependency chains for ILP.
// * Phase B is the beta sweep over the window's L rows in 8-row segments
//   (the renormalization group). It stores no betas, only the 32-byte
//   carry entering each segment above segment 0 (a checkpoint).
// * Phase C walks the segments upwards: it recomputes segment j's 8
//   stored betas from its checkpoint into registers (the segment loop is
//   unrolled, so the 64 values never leave them), then runs alpha and the
//   emission over them. The recompute repeats the same adds from the same
//   carry (a segment renormalizes only after its lowest row), so the betas
//   are bit-identical to a stored sweep. Segment 0's betas come straight
//   from phase B. The next segment's checkpoint is loaded one segment
//   ahead.
// * Every 8-row tile of lsa and lp is copied into a two-slot shared-memory
//   ring with cp.async one tile ahead of use; a thread copies and reads
//   only its own code block's column, so no barrier is needed. The padding
//   is never materialized: rows outside [0, K+3) are not copied, and the
//   read substitutes PAD_LLR and 0 by index.
//
// Where the checkpoints live. The 20 MHz uplink (1792 code blocks of
// K=5824, L 224, O 40) has only 46,592 threads = 1456 warps, and each runs
// ~750 dependent steps, so the kernel is bound by the latency of the
// recursion and wants every warp resident at once: 12 warps per SM. Kept
// in shared memory the 27 checkpoints (864 B per thread) allow 6 warps
// per SM, two waves; in a device-memory buffer [L/8 - 1][8][W*B] (40 MB,
// written once and read once, mostly from L2) they leave 8 KB of shared
// memory per block and one wave. Both were timed in turns on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md section 6): 0.152 ms here against
// 0.185 ms with the checkpoints on chip.
// The wrapper allocates the buffer (ops/fec/turbo_win.py win_plan gives
// its shape, the block size and the shared bytes); the launcher checks
// the plan. ptxas: 160 registers, no spills.
//
// What bounds it. The compulsory traffic is lsa and lp read once and llr
// written once: 12 bytes per bit, 0.125 GB at the uplink shape, a 0.037 ms
// bound. This design reads each window's rows twice (phases B and C) and
// its 2O overlap rows once more, and moves the checkpoints: ~0.32 GB.
//
// Built with --fmad=false: every product here is by 0.5 (exact).

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e30f)
#define PAD_LLR (1e5f)
// renormalization group = segment rows = staged tile rows
#define GROUP 8
// slots of the input ring; a slot holds 8 rows x 4 values
#define NSLOT 2
#define SLOT_VALS 4

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

__device__ __forceinline__ void alpha_step(float* alpha, float g00,
                                           float g01) {
  float br0[8], br1[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    br0[s] = alpha[s] + gsel(g00, g01, 0, tr_par(s, 0));
    br1[s] = alpha[s] + gsel(g00, g01, 1, tr_par(s, 1));
  }
#pragma unroll
  for (int s = 0; s < 8; ++s)
    alpha[s] = fmaxf(br0[tr_ps(s, 0)], br1[tr_ps(s, 1)]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most the NSLOT - 1 groups committed last are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSLOT - 1) : "memory");
}

// copy trellis rows t0 .. t0+7 of lsa, lp into values c, c+1 of a slot;
// rows outside [0, rows) are padding and are not copied
__device__ __forceinline__ void copy_tile(float* d, const float* lsa,
                                          const float* lp, long long t0,
                                          int rows, int B, int b, int c,
                                          int T) {
#pragma unroll
  for (int q = 0; q < GROUP; ++q) {
    const long long r = t0 + q;
    if (r >= 0 && r < rows) {
      float* e = d + (size_t)(q * SLOT_VALS + c) * T;
      cp_async4(e, lsa + (size_t)r * B + b);
      cp_async4(e + T, lp + (size_t)r * B + b);
    }
  }
}

// gammas of staged row q (trellis row r) from values c, c+1 of a slot:
// halved at load, padding substituted by index
__device__ __forceinline__ void gammas(const float* s, int q, int c,
                                       long long r, int rows, int T,
                                       float* g00, float* g01) {
  float ls, lq;
  if (r < 0 || r >= rows) {
    ls = PAD_LLR;
    lq = 0.0f;
  } else {
    const float* e = s + (size_t)(q * SLOT_VALS + c) * T;
    ls = e[0] * 0.5f;
    lq = e[T] * 0.5f;
  }
  *g00 = ls + lq;
  *g01 = ls - lq;
}

__global__ void __launch_bounds__(32) win_kernel(
    const float* __restrict__ lsa, const float* __restrict__ lp,
    float* __restrict__ llr, float* __restrict__ ckpt, int B, int K, int L,
    int O) {
  extern __shared__ float4 smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int b = blockIdx.x * T + t;
  const int w = blockIdx.y;
  if (b >= B) return;
  const int W = K / L;
  const int rows = K + 3;
  const long long row0 = (long long)w * L;
  const int nA = O / GROUP, nB = L / GROUP;
  const int nunit = nA + 2 * nB - 1;
  const size_t nthr = (size_t)W * B;
  float* ck = ckpt + (size_t)w * B + b;                  // [nB-1][8][W*B]
  float* ring = reinterpret_cast<float*>(smem) + t;      // [NSLOT][8][4][T]

  // unit v: v < nA trains (beta tile m = v from the top of the overlap
  // after the window, alpha tile m from the start of the overlap before
  // it); then phase B's segments nB-1 .. 0; then phase C's 1 .. nB-1
  // (segment 0's emission runs in phase B's last unit)
  auto seg_of = [nA, nB](int v) {
    return v < nA + nB ? nB - 1 - (v - nA) : v - (nA + nB) + 1;
  };
  auto slot = [&](int v) {
    return ring + (size_t)(v % NSLOT) * GROUP * SLOT_VALS * T;
  };
  auto load = [&](int v) {
    if (v < nunit) {
      float* d = slot(v);
      if (v < nA) {
        copy_tile(d, lsa, lp, row0 + L + O - GROUP * (v + 1), rows, B, b, 0,
                  T);
        copy_tile(d, lsa, lp, row0 - O + GROUP * v, rows, B, b, 2, T);
      } else {
        copy_tile(d, lsa, lp, row0 + GROUP * seg_of(v), rows, B, b, 0, T);
      }
    }
    cp_async_commit();
  };
  for (int v = 0; v < NSLOT - 1; ++v) load(v);

  // bk: the segment's stored betas; nxt: the next segment's checkpoint
  float beta[8], alpha[8], bk[GROUP][8], nxt[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    beta[s] = (w == W - 1 && s != 0) ? NEG : 0.0f;
    alpha[s] = (w == 0 && s != 0) ? NEG : 0.0f;
  }

  for (int v = 0; v < nunit; ++v) {
    load(v + NSLOT - 1);
    cp_async_wait_ring();
    const float* s = slot(v);
    if (v < nA) {
      // ---- phase A: beta and alpha training, interleaved ----
      const long long tb = row0 + L + O - GROUP * (v + 1);
      const long long ta = row0 - O + GROUP * v;
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int q = GROUP - 1 - k;
        float g00, g01, h00, h01;
        gammas(s, q, 0, tb + q, rows, T, &g00, &g01);
        gammas(s, k, 2, ta + k, rows, T, &h00, &h01);
        beta_step(beta, g00, g01);
        alpha_step(alpha, h00, h01);
      }
      norm8(beta);
      norm8(alpha);
      continue;
    }
    const int j = seg_of(v);
    const long long tr = row0 + GROUP * j;
    if (v < nA + nB) {
      // ---- phase B: beta sweep over segment j (renorm after its row 0) --
      if (j > 0) {
#pragma unroll
        for (int m = 0; m < 8; ++m)
          ck[((size_t)(j - 1) * 8 + m) * nthr] = beta[m];
      }
#pragma unroll
      for (int q = GROUP - 1; q >= 0; --q) {
        float g00, g01;
        gammas(s, q, 0, tr + q, rows, T, &g00, &g01);
        if (j == 0) {
#pragma unroll
          for (int m = 0; m < 8; ++m) bk[q][m] = beta[m];
        }
        beta_step(beta, g00, g01);
      }
      norm8(beta);
      if (j > 0) continue;
      if (nB > 1) {
#pragma unroll
        for (int m = 0; m < 8; ++m) nxt[m] = ck[(size_t)m * nthr];
      }
    } else {
      // ---- phase C: recompute segment j's betas from its checkpoint ----
#pragma unroll
      for (int m = 0; m < 8; ++m) beta[m] = nxt[m];
      if (j + 1 < nB) {
#pragma unroll
        for (int m = 0; m < 8; ++m) nxt[m] = ck[((size_t)j * 8 + m) * nthr];
      }
#pragma unroll
      for (int q = GROUP - 1; q >= 0; --q) {
        float g00, g01;
        gammas(s, q, 0, tr + q, rows, T, &g00, &g01);
#pragma unroll
        for (int m = 0; m < 8; ++m) bk[q][m] = beta[m];
        beta_step(beta, g00, g01);
      }
    }
    // ---- alpha sweep + emission over segment j (renorm after row 7) ----
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      float g00, g01;
      gammas(s, q, 0, tr + q, rows, T, &g00, &g01);
      float br0[8], br1[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        br0[m] = alpha[m] + gsel(g00, g01, 0, tr_par(m, 0));
        br1[m] = alpha[m] + gsel(g00, g01, 1, tr_par(m, 1));
      }
      float tot0 = br0[0] + bk[q][tr_ns(0, 0)];
      float tot1 = br1[0] + bk[q][tr_ns(0, 1)];
#pragma unroll
      for (int m = 1; m < 8; ++m) {
        tot0 = fmaxf(tot0, br0[m] + bk[q][tr_ns(m, 0)]);
        tot1 = fmaxf(tot1, br1[m] + bk[q][tr_ns(m, 1)]);
      }
      llr[(size_t)(tr + q) * B + b] = tot0 - tot1;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        alpha[m] = fmaxf(br0[tr_ps(m, 0)], br1[tr_ps(m, 1)]);
    }
    norm8(alpha);
  }
}

// shared bytes of a block (must equal ops/fec/turbo_win.py win_plan)
static size_t win_smem_bytes(int threads) {
  return (size_t)threads * 4 * NSLOT * GROUP * SLOT_VALS;
}

extern "C" int turbo_win_launch(const float* lsa, const float* lp,
                                float* llr, float* ckpt, int B, int K, int L,
                                int O, int threads, int smem_bytes,
                                void* stream) {
  if (threads != 32 || L % GROUP != 0 || O % GROUP != 0 || O > L ||
      K % L != 0 || (size_t)smem_bytes != win_smem_bytes(threads))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + threads - 1) / threads),
                  (unsigned)(K / L));
  win_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      lsa, lp, llr, ckpt, B, K, L, O);
  return (int)cudaGetLastError();
}
