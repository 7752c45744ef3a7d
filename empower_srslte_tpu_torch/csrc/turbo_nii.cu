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
// thread per pair. A block is one warp of 32 neighbouring code blocks of
// one window, so each trellis row of the time-major [K, B] inputs is one
// coalesced 128-byte line. The 8 alpha or beta metrics live in registers
// (the trellis wiring is constant-folded by full unrolling). Nothing but
// the inputs, the outputs and the boundary metrics touches device memory:
//
// * Checkpoint and recompute. The window's rows are cut into segments of
//   SEG = 16 rows aligned with the renormalization group (the last one is
//   8 rows when l % 16 == 8). The backward sweep stores no betas, only the
//   8-metric carry entering each segment above segment 0 (a checkpoint),
//   in shared memory. The forward sweep recomputes segment j's 16 stored
//   betas from its checkpoint into registers (the segment loops are
//   unrolled, so the 128 values never leave them), then runs alpha and the
//   emission over them. The recompute repeats the same adds from the same
//   carry (a segment renormalizes only after its lowest row), so the
//   betas are bit-identical to a stored sweep. Segment 0's betas come
//   straight from the backward sweep, so it is never recomputed.
// * Staged inputs. Each segment's rows of u, p (and apr) are copied into a
//   two-slot shared-memory ring with cp.async one segment ahead of use;
//   every thread copies and reads only its own code block's column, so the
//   ring needs no barrier, only the thread's own cp.async.wait_group.
//   The stream of segments is nseg-1 .. 0 (backward), then 1 .. nseg-1
//   (forward; segment 0 is still in its slot).
//
// Resources at the main path's shape (l = 240, with apr), on an H100:
// 832 B of shared memory per thread (14 checkpoints x 32 B, 2 x 16 rows
// x 12 B of ring), 26,624 B per 32-thread block, so 8 blocks per SM;
// ptxas gives 188 registers (168 without apr) and no spills, which also
// fits 8 warps. Measured alternatives (PERF.md section 6), all slower: the
// segment betas in shared memory (5 warps per SM), a 3- or 4-slot ring
// (fewer blocks), the checkpoints in a device-memory buffer (more warps,
// more traffic). The launch plan (block size, segments, bytes) comes from
// the Python wrapper (ops/fec/turbo_nii.py nii_plan); the launcher checks
// it.
//
// What bounds it. Per half-iteration and bit it reads u, p, apr twice (once
// per sweep; the second read finds little in L2) and writes ext once: 28
// bytes against the 16 the function must move. At 5120 code blocks of
// K=5760 that is ~0.84 GB, 0.25 ms at 3.35 TB/s, against the 0.146 ms
// bound of the compulsory bytes. It issues about 120 float adds/maxes per
// step plus ~30 for the recompute: ~4.4e9 operations, 0.13 ms at the
// non-FMA float32 rate, so device-memory traffic and the latency of the
// recursion at 8 warps per SM bound it.
//
// Built with --fmad=false: every product here is by 0.5 (exact), so FMA
// contraction would not change results, but the flag keeps it certain.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e30f)
// rows per segment: the renormalization group
#define SEG 16
// slots of the input ring
#define NSLOT 2

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

// 8 metrics <-> two float4 of a [n][2][T] shared array (thread fastest)
__device__ __forceinline__ void put8(float4* dst, int T, const float* v) {
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[T] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void get8(const float4* src, int T, float* v) {
  const float4 a = src[0], c = src[T];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
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

// staged row i of a slot: uu = u (+ apr), pp = p
template <bool APR>
__device__ __forceinline__ void stage_row(const float* s, int i, int T,
                                          float* uu, float* pp) {
  constexpr int NIN = APR ? 3 : 2;
  const float* q = s + (size_t)i * NIN * T;
  float x = q[0];
  if (APR) x = x + q[2 * T];
  *uu = x;
  *pp = q[T];
}

// N backward steps over a staged segment, rows N-1 .. 0; with STORE the
// carry entering each row goes to the segment buffer
template <bool APR, int N, bool STORE>
__device__ __forceinline__ void seg_backward(float* beta, const float* s,
                                             float (*bk)[8], int T) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float uu, pp;
    stage_row<APR>(s, i, T, &uu, &pp);
    if (STORE) {
#pragma unroll
      for (int m = 0; m < 8; ++m) bk[i][m] = beta[m];
    }
    beta_step(beta, (uu + pp) * 0.5f, (uu - pp) * 0.5f);
  }
}

// N forward steps over a staged segment starting at window row r0:
// alpha recursion and the extrinsic emission
template <bool APR, int N>
__device__ __forceinline__ void seg_forward(float* alpha, const float* s,
                                            const float (*bk)[8], int T,
                                            float* ext_col, int B, int r0,
                                            int l) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float uu, pp;
    stage_row<APR>(s, i, T, &uu, &pp);
    const float g00 = (uu + pp) * 0.5f;
    const float g01 = (uu - pp) * 0.5f;
    const float* bk1 = bk[i];
    float br0[8], br1[8];
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      br0[st] = alpha[st] + gsel(g00, g01, 0, tr_par(st, 0));
      br1[st] = alpha[st] + gsel(g00, g01, 1, tr_par(st, 1));
    }
    float tot0 = br0[0] + bk1[tr_ns(0, 0)];
    float tot1 = br1[0] + bk1[tr_ns(0, 1)];
#pragma unroll
    for (int st = 1; st < 8; ++st) {
      tot0 = fmaxf(tot0, br0[st] + bk1[tr_ns(st, 0)]);
      tot1 = fmaxf(tot1, br1[st] + bk1[tr_ns(st, 1)]);
    }
    ext_col[(size_t)i * B] = (tot0 - tot1) - uu;
#pragma unroll
    for (int st = 0; st < 8; ++st)
      alpha[st] = fmaxf(br0[tr_ps(st, 0)], br1[tr_ps(st, 1)]);
    const int r = r0 + i;
    if ((r & 15) == 15 || r == l - 1) norm8(alpha);
  }
}

template <bool APR>
__global__ void __launch_bounds__(32) nii_kernel(
    const float* __restrict__ u, const float* __restrict__ p,
    const float* __restrict__ apr, const float* __restrict__ tail_u,
    const float* __restrict__ tail_p, const float* __restrict__ a_st,
    const float* __restrict__ b_st, float* __restrict__ ext,
    float* __restrict__ a_next, float* __restrict__ b_next, int B, int l,
    int W, int first_w, int last_w) {
  constexpr int NIN = APR ? 3 : 2;
  extern __shared__ float4 smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int b = blockIdx.x * T + t;
  const int w = blockIdx.y;
  if (b >= B) return;
  const int nseg = (l + SEG - 1) / SEG;
  const int nunit = 2 * nseg - 1;
  float4* ck = smem + t;                                  // [nseg-1][2][T]
  float* ring = reinterpret_cast<float*>(smem + (size_t)(nseg - 1) * 2 * T)
                + t;                                 // [NSLOT][SEG][NIN][T]
  const size_t row0 = (size_t)w * l;

  // unit v's segment: backward units walk nseg-1 .. 0, forward units
  // (v >= nseg) 1 .. nseg-1; segment 0's forward runs in unit nseg-1
  auto seg_of = [nseg](int v) {
    return v < nseg ? nseg - 1 - v : v - nseg + 1;
  };
  auto slot = [&](int v) {
    return ring + (size_t)(v % NSLOT) * SEG * NIN * T;
  };
  auto load = [&](int v) {
    if (v < nunit) {
      const int r0 = seg_of(v) * SEG, n = min(SEG, l - r0);
      float* d = slot(v);
      for (int i = 0; i < n; ++i, d += NIN * T) {
        const size_t g = (row0 + r0 + i) * B + b;
        cp_async4(d, u + g);
        cp_async4(d + T, p + g);
        if (APR) cp_async4(d + 2 * T, apr + g);
      }
    }
    cp_async_commit();
  };
  for (int v = 0; v < NSLOT - 1; ++v) load(v);

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

  float alpha[8], bk[SEG][8];
  for (int v = 0; v < nunit; ++v) {
    load(v + NSLOT - 1);
    cp_async_wait_ring();
    const int j = seg_of(v);
    const int r0 = j * SEG;
    const bool full = l - r0 >= SEG;   // else the 8-row top segment
    const float* s = slot(v);
    if (v < nseg) {
      // ---- backward sweep over segment j (renorm after its row r0) ----
      if (j > 0) {
        put8(ck + (size_t)(j - 1) * 2 * T, T, beta);
        if (full) seg_backward<APR, SEG, false>(beta, s, bk, T);
        else      seg_backward<APR, SEG / 2, false>(beta, s, bk, T);
        norm8(beta);
        continue;
      }
      seg_backward<APR, SEG, true>(beta, s, bk, T);
      norm8(beta);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        b_next[((size_t)w * 8 + q) * B + b] = beta[q];
        if (w == W - 1) b_next[((size_t)W * 8 + q) * B + b] = 0.0f;
      }
      if (w == first_w) {
#pragma unroll
        for (int q = 0; q < 8; ++q) alpha[q] = q == 0 ? 0.0f : NEG;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          alpha[q] = a_st[((size_t)w * 8 + q) * B + b];
      }
    } else {
      // ---- recompute segment j's betas from its checkpoint ----
      get8(ck + (size_t)(j - 1) * 2 * T, T, beta);
      if (full) seg_backward<APR, SEG, true>(beta, s, bk, T);
      else      seg_backward<APR, SEG / 2, true>(beta, s, bk, T);
    }
    // ---- forward sweep + extrinsic emission over segment j ----
    float* ext_col = ext + (row0 + r0) * B + b;
    if (full) seg_forward<APR, SEG>(alpha, s, bk, T, ext_col, B, r0, l);
    else      seg_forward<APR, SEG / 2>(alpha, s, bk, T, ext_col, B, r0, l);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a_next[((size_t)(w + 1) * 8 + s) * B + b] = alpha[s];
    if (w == 0) a_next[(size_t)s * B + b] = 0.0f;
  }
}

// shared bytes of a block (must equal ops/fec/turbo_nii.py nii_plan)
static size_t nii_smem_bytes(int l, int threads, bool apr) {
  const int nseg = (l + SEG - 1) / SEG;
  return (size_t)threads * (32 * (size_t)(nseg - 1)
                            + 4 * (size_t)NSLOT * SEG * (apr ? 3 : 2));
}

extern "C" int turbo_nii_launch(const float* u, const float* p,
                                const float* apr, const float* tail_u,
                                const float* tail_p, const float* a_st,
                                const float* b_st, float* ext, float* a_next,
                                float* b_next, int B, int l, int W,
                                int first_w, int last_w, int threads,
                                int smem_bytes, void* stream) {
  const bool has_apr = apr != nullptr;
  if (threads != 32 || l % 8 != 0 || l < SEG ||
      (size_t)smem_bytes != nii_smem_bytes(l, threads, has_apr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)W);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (has_apr) {
    e = cudaFuncSetAttribute(nii_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    nii_kernel<true><<<grid, threads, smem_bytes, st>>>(
        u, p, apr, tail_u, tail_p, a_st, b_st, ext, a_next, b_next, B, l, W,
        first_w, last_w);
  } else {
    e = cudaFuncSetAttribute(nii_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    nii_kernel<false><<<grid, threads, smem_bytes, st>>>(
        u, p, apr, tail_u, tail_p, a_st, b_st, ext, a_next, b_next, B, l, W,
        first_w, last_w);
  }
  return (int)cudaGetLastError();
}
