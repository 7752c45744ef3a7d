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
//
// bfloat16 (win_kernel<OpsBf16x2>, launcher turbo_win_launch_bf16). The
// JAX v1 decoder feeds its kernel bfloat16 whenever it takes the kernel
// path with dtype "auto" (turbo_decoder.py:531-533), and the kernel then
// rounds every operation to bfloat16. Here one thread decodes two
// neighbouring code blocks packed in one bf16x2 register (code block 2j
// in the low half; B even, the wrapper pads an odd batch), so a warp
// covers 64 code blocks and a trellis row is still one 128-byte line. The
// same template runs add/sub/mul.rn.bf16x2 and max/neg.bf16x2: rows are
// halved at load (one rounding, exact), gammas ls + lp and ls - lp, branch
// sums alpha + g then + beta, one rounding per operation, no FMA. The
// padding reads PAD_LLR rounded to bfloat16 (99,840, what the JAX
// decoder's jnp.full(..., 1e5, bf16) holds) and 0; the boundary metric is
// bf16(-1e30), which no g moves. The checkpoints are 8 bf16x2 values per
// thread, so the wrapper's buffer holds half the bytes per code block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e30f)
#define PAD_LLR (1e5f)
// renormalization group = segment rows = staged tile rows
#define GROUP 8
// slots of the input ring; a slot holds 8 rows x 4 values
#define NSLOT 2
#define SLOT_VALS 4

// The metric arithmetic: float32, or two bfloat16 code blocks per register
// with every operation rounded to nearest even (sm_90 add/sub/mul.rn).
struct OpsF32 {
  typedef float T;
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  static __device__ __forceinline__ T max(T a, T b) { return fmaxf(a, b); }
  static __device__ __forceinline__ T neg(T a) { return -a; }
  static __device__ __forceinline__ T half(T a) { return a * 0.5f; }
  static __device__ __forceinline__ T lit(float x) { return x; }
};

struct OpsBf16x2 {
  typedef __nv_bfloat162 T;
  static __device__ __forceinline__ unsigned bits(T a) {
    return *reinterpret_cast<unsigned*>(&a);
  }
  static __device__ __forceinline__ T of(unsigned v) {
    return *reinterpret_cast<T*>(&v);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return of(d);
  }
  static __device__ __forceinline__ T sub(T a, T b) {
    unsigned d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return of(d);
  }
  static __device__ __forceinline__ T max(T a, T b) {
    unsigned d;
    asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return of(d);
  }
  static __device__ __forceinline__ T neg(T a) {
    unsigned d;
    asm("neg.bf16x2 %0, %1;" : "=r"(d) : "r"(bits(a)));
    return of(d);
  }
  static __device__ __forceinline__ T half(T a) {
    unsigned d;
    // 0x3f00 is bfloat16 0.5 in both halves
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)),
        "r"(0x3f003f00u));
    return of(d);
  }
  static __device__ __forceinline__ T lit(float x) {
    return __float2bfloat162_rn(x);
  }
};

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
template <class Op>
__device__ __forceinline__ typename Op::T gsel(typename Op::T g00,
                                               typename Op::T g01, int u,
                                               int par) {
  return u == 0 ? (par == 0 ? g00 : g01)
                : (par == 0 ? Op::neg(g01) : Op::neg(g00));
}

template <class Op>
__device__ __forceinline__ void norm8(typename Op::T* v) {
  typename Op::T m = v[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) m = Op::max(m, v[s]);
#pragma unroll
  for (int s = 0; s < 8; ++s) v[s] = Op::sub(v[s], m);
}

template <class Op>
__device__ __forceinline__ void beta_step(typename Op::T* beta,
                                          typename Op::T g00,
                                          typename Op::T g01) {
  typename Op::T nb[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    typename Op::T c0 =
        Op::add(beta[tr_ns(s, 0)], gsel<Op>(g00, g01, 0, tr_par(s, 0)));
    typename Op::T c1 =
        Op::add(beta[tr_ns(s, 1)], gsel<Op>(g00, g01, 1, tr_par(s, 1)));
    nb[s] = Op::max(c0, c1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = nb[s];
}

template <class Op>
__device__ __forceinline__ void alpha_step(typename Op::T* alpha,
                                           typename Op::T g00,
                                           typename Op::T g01) {
  typename Op::T br0[8], br1[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    br0[s] = Op::add(alpha[s], gsel<Op>(g00, g01, 0, tr_par(s, 0)));
    br1[s] = Op::add(alpha[s], gsel<Op>(g00, g01, 1, tr_par(s, 1)));
  }
#pragma unroll
  for (int s = 0; s < 8; ++s)
    alpha[s] = Op::max(br0[tr_ps(s, 0)], br1[tr_ps(s, 1)]);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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
template <class V>
__device__ __forceinline__ void copy_tile(V* d, const V* lsa, const V* lp,
                                          long long t0, int rows, int B,
                                          int b, int c, int T) {
#pragma unroll
  for (int q = 0; q < GROUP; ++q) {
    const long long r = t0 + q;
    if (r >= 0 && r < rows) {
      V* e = d + (size_t)(q * SLOT_VALS + c) * T;
      cp_async4(e, lsa + (size_t)r * B + b);
      cp_async4(e + T, lp + (size_t)r * B + b);
    }
  }
}

// gammas of staged row q (trellis row r) from values c, c+1 of a slot:
// halved at load, padding substituted by index
template <class Op>
__device__ __forceinline__ void gammas(const typename Op::T* s, int q, int c,
                                       long long r, int rows, int T,
                                       typename Op::T* g00,
                                       typename Op::T* g01) {
  typename Op::T ls, lq;
  if (r < 0 || r >= rows) {
    ls = Op::lit(PAD_LLR);
    lq = Op::lit(0.0f);
  } else {
    const typename Op::T* e = s + (size_t)(q * SLOT_VALS + c) * T;
    ls = Op::half(e[0]);
    lq = Op::half(e[T]);
  }
  *g00 = Op::add(ls, lq);
  *g01 = Op::sub(ls, lq);
}

// B: columns of the [K+3, B] arrays in units of Op::T (code blocks in
// float32, code block pairs in bf16x2)
template <class Op>
__global__ void __launch_bounds__(32) win_kernel(
    const typename Op::T* __restrict__ lsa,
    const typename Op::T* __restrict__ lp, typename Op::T* __restrict__ llr,
    typename Op::T* __restrict__ ckpt, int B, int K, int L, int O) {
  typedef typename Op::T V;
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
  const V zero = Op::lit(0.0f), neg = Op::lit(NEG);
  V* ck = ckpt + (size_t)w * B + b;                      // [nB-1][8][W*B]
  V* ring = reinterpret_cast<V*>(smem) + t;              // [NSLOT][8][4][T]

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
      V* d = slot(v);
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
  V beta[8], alpha[8], bk[GROUP][8], nxt[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    beta[s] = (w == W - 1 && s != 0) ? neg : zero;
    alpha[s] = (w == 0 && s != 0) ? neg : zero;
  }

  for (int v = 0; v < nunit; ++v) {
    load(v + NSLOT - 1);
    cp_async_wait_ring();
    const V* s = slot(v);
    if (v < nA) {
      // ---- phase A: beta and alpha training, interleaved ----
      const long long tb = row0 + L + O - GROUP * (v + 1);
      const long long ta = row0 - O + GROUP * v;
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int q = GROUP - 1 - k;
        V g00, g01, h00, h01;
        gammas<Op>(s, q, 0, tb + q, rows, T, &g00, &g01);
        gammas<Op>(s, k, 2, ta + k, rows, T, &h00, &h01);
        beta_step<Op>(beta, g00, g01);
        alpha_step<Op>(alpha, h00, h01);
      }
      norm8<Op>(beta);
      norm8<Op>(alpha);
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
        V g00, g01;
        gammas<Op>(s, q, 0, tr + q, rows, T, &g00, &g01);
        if (j == 0) {
#pragma unroll
          for (int m = 0; m < 8; ++m) bk[q][m] = beta[m];
        }
        beta_step<Op>(beta, g00, g01);
      }
      norm8<Op>(beta);
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
        V g00, g01;
        gammas<Op>(s, q, 0, tr + q, rows, T, &g00, &g01);
#pragma unroll
        for (int m = 0; m < 8; ++m) bk[q][m] = beta[m];
        beta_step<Op>(beta, g00, g01);
      }
    }
    // ---- alpha sweep + emission over segment j (renorm after row 7) ----
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      V g00, g01;
      gammas<Op>(s, q, 0, tr + q, rows, T, &g00, &g01);
      V br0[8], br1[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        br0[m] = Op::add(alpha[m], gsel<Op>(g00, g01, 0, tr_par(m, 0)));
        br1[m] = Op::add(alpha[m], gsel<Op>(g00, g01, 1, tr_par(m, 1)));
      }
      V tot0 = Op::add(br0[0], bk[q][tr_ns(0, 0)]);
      V tot1 = Op::add(br1[0], bk[q][tr_ns(0, 1)]);
#pragma unroll
      for (int m = 1; m < 8; ++m) {
        tot0 = Op::max(tot0, Op::add(br0[m], bk[q][tr_ns(m, 0)]));
        tot1 = Op::max(tot1, Op::add(br1[m], bk[q][tr_ns(m, 1)]));
      }
      llr[(size_t)(tr + q) * B + b] = Op::sub(tot0, tot1);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        alpha[m] = Op::max(br0[tr_ps(m, 0)], br1[tr_ps(m, 1)]);
    }
    norm8<Op>(alpha);
  }
}

// shared bytes of a block (must equal ops/fec/turbo_win.py win_plan): 4 B
// per staged value in both types
static size_t win_smem_bytes(int threads) {
  return (size_t)threads * 4 * NSLOT * GROUP * SLOT_VALS;
}

// cols: columns of the arrays in units of Op::T
template <class Op>
static int win_launch(const void* lsa, const void* lp, void* llr, void* ckpt,
                      int cols, int K, int L, int O, int threads,
                      int smem_bytes, void* stream) {
  typedef typename Op::T V;
  if (threads != 32 || L % GROUP != 0 || O % GROUP != 0 || O > L ||
      K % L != 0 || (size_t)smem_bytes != win_smem_bytes(threads))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cols + threads - 1) / threads),
                  (unsigned)(K / L));
  win_kernel<Op><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const V*)lsa, (const V*)lp, (V*)llr, (V*)ckpt, cols, K, L, O);
  return (int)cudaGetLastError();
}

// float32: B code blocks, one per thread
extern "C" int turbo_win_launch(const void* lsa, const void* lp, void* llr,
                                void* ckpt, int B, int K, int L, int O,
                                int threads, int smem_bytes, void* stream) {
  return win_launch<OpsF32>(lsa, lp, llr, ckpt, B, K, L, O, threads,
                            smem_bytes, stream);
}

// bfloat16: B code blocks (even), two per thread
extern "C" int turbo_win_launch_bf16(const void* lsa, const void* lp,
                                     void* llr, void* ckpt, int B, int K,
                                     int L, int O, int threads,
                                     int smem_bytes, void* stream) {
  if (B % 2 != 0) return (int)cudaErrorInvalidValue;
  return win_launch<OpsBf16x2>(lsa, lp, llr, ckpt, B / 2, K, L, O, threads,
                               smem_bytes, stream);
}
