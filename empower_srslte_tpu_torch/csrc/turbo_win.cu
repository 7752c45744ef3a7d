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
// bfloat16 (launcher turbo_win_launch_bf16). The JAX v1 decoder feeds its
// kernel bfloat16 whenever it takes the kernel path with dtype "auto"
// (turbo_decoder.py:531-533), and the kernel then rounds every operation
// to bfloat16. Both bfloat16 kernels hold two neighbouring code blocks in
// one bf16x2 register (code block 2j in the low half) and run
// add/sub/mul.rn.bf16x2 and max/neg.bf16x2: rows are halved at load (one
// rounding, exact), gammas ls + lp and ls - lp, branch sums alpha + g then
// + beta, one rounding per operation, no FMA. The padding reads PAD_LLR
// rounded to bfloat16 (99,840, what the JAX decoder's jnp.full(..., 1e5,
// bf16) holds) and 0; the boundary metric is bf16(-1e30), which no g
// moves. The plan (ops/fec/turbo_win.py win_plan) picks the kernel by the
// launch's shape:
//
// * Split kernel (win_split_kernel<OpsBf16x2, Cols>), up to one wave of
//   split blocks (six per SM at the uplink's window; the plan counts the
//   card's SMs; the crossover was timed between 5.5 and 7.1 a SM), which
//   covers the 20 MHz uplink. What bounds the
//   one-thread schedule there is the latency of the recursion: its 728
//   warps are one partial wave, and twice the code blocks take only 1.28x
//   the time. So each window of a code block pair gets two threads in two
//   warps of one block: the alpha side trains over the O rows before the
//   window and runs alpha up the lower half of its segments, the beta side
//   trains over the O rows after it and runs beta down the upper half,
//   each keeping the carry entering every segment (in shared memory: 28
//   checkpoints at L 224, no device buffer); they meet at a named
//   barrier, then each crosses into the other's half, recomputing the
//   other recursion's segment from its checkpoint and emitting. A thread's
//   chain is half the one-thread kernel's, at 119 registers and 12 warps
//   per SM. Any batch: with an odd B, or arrays off a 4-byte boundary, a
//   lane's pair may straddle two aligned words, so a row's 32 pairs are
//   staged as the 33 words they span and each lane picks its pair with
//   one byte permute (ShiftedCols, 124 registers, 1.3-1.5x the time of
//   AlignedCols, which the plan takes wherever it can); the missing half
//   of an odd batch's last pair is never stored.
// * One-thread kernel (win_kernel<OpsBf16x2>): the float32 schedule above
//   with a code block pair per thread and the checkpoints in the
//   wrapper's buffer, for an even batch on 4-byte aligned arrays above
//   that size, where the launch is throughput-bound and the split
//   kernel's extra instructions (the beta side's branch sums for its
//   emission) lose.

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
  // the 4 bytes of a metric as a float (for 16-byte shared stores)
  static __device__ __forceinline__ float pack(T a) {
    return __uint_as_float(bits(a));
  }
  static __device__ __forceinline__ T unpack(float a) {
    return of(__float_as_uint(a));
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

// ---------------------------------------------------------------------
// bfloat16: the split kernel (win_split_kernel<OpsBf16x2, Cols>)
// ---------------------------------------------------------------------

// code block pairs per block: one warp per side
#define PPB 32

// cp_async4 where p holds (a predicated copy, no branch)
__device__ __forceinline__ void cp_async4_if(bool p, void* dst,
                                             const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(s),
      "l"(src), "r"((int)p)
      : "memory");
}
// the block's two warps meet (a named barrier that each warp may reach
// from its own code)
__device__ __forceinline__ void sides_meet() {
  asm volatile("barrier.sync 1, %0;\n" ::"n"(2 * PPB) : "memory");
}

// A lane's code block pair (2j, 2j+1) in the [rows, B] bfloat16 arrays,
// staged in rows of RW 32-bit words. AlignedCols: B even and every
// staged array 4-byte aligned, so the pair is one aligned word, staged at
// word `lane`, read and stored as such. ShiftedCols: any B and
// alignment; a row's 32 pairs lie in the 33 aligned words from the one
// holding the block's first element: lane j stages word j (and lane 31
// word 32 too), reads words j and j + 1 and picks its pair with one byte
// permute, whose selector a unit fixes per row parity (odd B flips the
// straddle on odd rows; sh0 bit q is array q's start), and stores its
// halves one by one. The plan picks
// the columns (ops/fec/turbo_nii.py split_plan) and the launcher refuses
// AlignedCols on an odd B or arrays off a 4-byte boundary.
struct AlignedCols {
  static constexpr int RW = 32;
  int lane, B;
  bool live, hi;
  size_t col;               // element 2j of row 0
  __device__ __forceinline__ void stage(unsigned* dst,
                                        const unsigned short* base,
                                        size_t row, size_t) const {
    if (live) cp_async4(dst + lane, base + row * B + col);
  }
  __device__ __forceinline__ void start(long long) {}
  __device__ __forceinline__ unsigned pair(const unsigned* s, int,
                                           int) const {
    return s[lane];
  }
  __device__ __forceinline__ void store(unsigned short* base, size_t row,
                                        unsigned v) const {
    if (live) *reinterpret_cast<unsigned*>(base + row * B + col) = v;
  }
};
struct ShiftedCols {
  static constexpr int RW = 33;
  int lane, B;
  bool live, hi;
  size_t col;
  unsigned sh0;
  // every lane stages, live or not (its word may hold the last live
  // pair's high half). Words are read whole: the first may begin 2 bytes
  // before the array or end 2 bytes past it (no word crosses a page), and
  // a word past the array's last reads that last word again; the halves
  // these add belong to no code block and are never stored. No branch on
  // the array's end and no zero-fill copy: either cost latency-bound
  // launches 1.6-1.8x, and two words a lane cost a wave (PERF.md)
  __device__ __forceinline__ void stage(unsigned* dst,
                                        const unsigned short* base,
                                        size_t row, size_t n_el) const {
    const uintptr_t w = (uintptr_t)(base + row * B + col) & ~(uintptr_t)3;
    const uintptr_t last = (uintptr_t)(base + n_el - 1) & ~(uintptr_t)3;
    cp_async4(dst + lane, (const void*)min(w, last));
    cp_async4_if(lane == 31, dst + 32, (const void*)min(w + 4, last));
  }
  // the byte-permute selectors of a unit's rows from trellis row r0 on,
  // by row parity and array
  unsigned sel[2][3];
  __device__ __forceinline__ void start(long long r0) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        sel[par][q] = 0x3210 + 0x2222 * (((((unsigned)r0 + par) &
                                            (unsigned)B) ^ (sh0 >> q)) & 1);
    }
  }
  // the pair of the unit's row i from array q
  __device__ __forceinline__ unsigned pair(const unsigned* s, int i,
                                           int q) const {
    return __byte_perm(s[lane], s[lane + 1], sel[i & 1][q]);
  }
  __device__ __forceinline__ void store(unsigned short* base, size_t row,
                                        unsigned v) const {
    if (!live) return;
    unsigned short* a = base + row * B + col;
    a[0] = (unsigned short)v;
    if (hi) a[1] = (unsigned short)(v >> 16);
  }
};
__device__ __forceinline__ void set_shift(AlignedCols&, int, unsigned) {}
__device__ __forceinline__ void set_shift(ShiftedCols& c, int,
                                          unsigned sh0) {
  c.sh0 = sh0;
}

// 8 metrics <-> two float4 of a [n][2][T] shared array (thread fastest)
template <class Op>
__device__ __forceinline__ void put8(float4* dst, int T,
                                     const typename Op::T* v) {
  dst[0] = make_float4(Op::pack(v[0]), Op::pack(v[1]), Op::pack(v[2]),
                       Op::pack(v[3]));
  dst[T] = make_float4(Op::pack(v[4]), Op::pack(v[5]), Op::pack(v[6]),
                       Op::pack(v[7]));
}
template <class Op>
__device__ __forceinline__ void get8(const float4* src, int T,
                                     typename Op::T* v) {
  const float4 a = src[0], c = src[T];
  v[0] = Op::unpack(a.x); v[1] = Op::unpack(a.y);
  v[2] = Op::unpack(a.z); v[3] = Op::unpack(a.w);
  v[4] = Op::unpack(c.x); v[5] = Op::unpack(c.y);
  v[6] = Op::unpack(c.z); v[7] = Op::unpack(c.w);
}

// gammas of staged row q (trellis row r): halved at load, padding rows
// (outside [0, rows)) substituted by index
template <class Op, class C>
__device__ __forceinline__ void split_gammas(const unsigned* s, int q,
                                             long long r, int rows,
                                             const C& c,
                                             typename Op::T* g00,
                                             typename Op::T* g01) {
  typename Op::T ls, lq;
  if (r < 0 || r >= rows) {
    ls = Op::lit(PAD_LLR);
    lq = Op::lit(0.0f);
  } else {
    const unsigned* e = s + q * 2 * C::RW;
    ls = Op::half(OpsBf16x2::of(c.pair(e, q, 0)));
    lq = Op::half(OpsBf16x2::of(c.pair(e + C::RW, q, 1)));
  }
  *g00 = Op::add(ls, lq);
  *g01 = Op::sub(ls, lq);
}

// llr of one row from its branch sums and the beta entering it (the
// backward carry before the row's step): max(alpha + g + beta) over the
// states, u = 0 minus u = 1
template <class Op>
__device__ __forceinline__ typename Op::T emit(const typename Op::T* br0,
                                               const typename Op::T* br1,
                                               const typename Op::T* beta) {
  typename Op::T tot0 = Op::add(br0[0], beta[tr_ns(0, 0)]);
  typename Op::T tot1 = Op::add(br1[0], beta[tr_ns(0, 1)]);
#pragma unroll
  for (int m = 1; m < 8; ++m) {
    tot0 = Op::max(tot0, Op::add(br0[m], beta[tr_ns(m, 0)]));
    tot1 = Op::max(tot1, Op::add(br1[m], beta[tr_ns(m, 1)]));
  }
  return Op::sub(tot0, tot1);
}

template <class Op>
__device__ __forceinline__ void branches(const typename Op::T* alpha,
                                         typename Op::T g00,
                                         typename Op::T g01,
                                         typename Op::T* br0,
                                         typename Op::T* br1) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    br0[m] = Op::add(alpha[m], gsel<Op>(g00, g01, 0, tr_par(m, 0)));
    br1[m] = Op::add(alpha[m], gsel<Op>(g00, g01, 1, tr_par(m, 1)));
  }
}

// The split schedule: a block holds PPB code block pairs of one window in
// two warps. The alpha side (warp 0) trains alpha over the O rows before
// the window and runs it up the window's lower h segments; the beta side
// (warp 1) trains beta over the O rows after the window and runs it down
// the upper nseg - h segments; each keeps the carry entering every
// segment (a checkpoint, in shared memory). They meet; then the alpha
// side walks the upper segments upwards, recomputing each one's betas
// from the beta side's checkpoint and emitting, while the beta side walks
// the lower segments downwards, recomputing each one's alphas from the
// alpha side's checkpoint and emitting. Every alpha and beta is the one
// the JAX kernel's sweeps compute (the same adds from the same carries,
// renormalization by row), so the result is bit-identical.
template <class Op, class C>
__global__ void __launch_bounds__(2 * PPB) win_split_kernel(
    const unsigned short* __restrict__ lsa,
    const unsigned short* __restrict__ lp, unsigned short* __restrict__ llr,
    int B, int K, int L, int O) {
  typedef typename Op::T V;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, side = threadIdx.x >> 5;
  const int jb = blockIdx.x * PPB;
  const int w = blockIdx.y;
  const int W = K / L, rows = K + 3;
  C c;
  c.lane = lane;
  c.B = B;
  c.live = 2 * (jb + lane) < B;
  c.hi = 2 * (jb + lane) + 1 < B;
  c.col = 2 * (size_t)(jb + lane);
  set_shift(c, jb, (((uintptr_t)lsa >> 1) & 1) |
                       ((((uintptr_t)lp >> 1) & 1) << 1));
  const long long row0 = (long long)w * L;
  const int nA = O / GROUP, nseg = L / GROUP;
  const int h = nseg / 2;
  const int nunit = nA + nseg;
  const int n1 = nA + (side == 0 ? h : nseg - h);   // phase-1 units
  const size_t nel = (size_t)rows * B;
  const V zero = Op::lit(0.0f), neg = Op::lit(NEG);
  float4* ck = smem + lane;                                // [nseg][2][PPB]
  unsigned* ring = reinterpret_cast<unsigned*>(smem + (size_t)nseg * 2 * PPB)
                   + (size_t)side * NSLOT * GROUP * 2 * C::RW;

  // unit v's first trellis row: the alpha side's training tiles from
  // wL - O upwards, then the window's segments 0 .. nseg-1; the beta
  // side's training tiles from wL + L + O - 8 downwards, then the
  // window's segments nseg-1 .. 0
  auto tile_row = [&](int v) -> long long {
    if (v < nA)
      return side == 0 ? row0 - O + GROUP * v
                       : row0 + L + O - GROUP * (v + 1);
    return row0 + GROUP * (side == 0 ? v - nA : nseg - 1 - (v - nA));
  };
  auto slot = [&](int v) {
    return ring + (size_t)(v % NSLOT) * GROUP * 2 * C::RW;
  };
  auto load = [&](int v) {
    if (v < nunit) {
      const long long t0 = tile_row(v);
      unsigned* d = slot(v);
      for (int q = 0; q < GROUP; ++q, d += 2 * C::RW) {
        const long long r = t0 + q;
        if (r >= 0 && r < rows) {
          c.stage(d, lsa, (size_t)r, nel);
          c.stage(d + C::RW, lp, (size_t)r, nel);
        }
      }
    }
    cp_async_commit();
  };
  for (int v = 0; v < NSLOT - 1; ++v) load(v);

  // alpha side: alpha (mk: the recomputed betas); beta side: beta (mk:
  // the recomputed alphas)
  V alpha[8], beta[8], mk[GROUP][8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    alpha[m] = (w == 0 && m != 0) ? neg : zero;
    beta[m] = (w == W - 1 && m != 0) ? neg : zero;
  }

  for (int v = 0; v < nunit; ++v) {
    __syncwarp();             // every lane is done with the slot refilled
    load(v + NSLOT - 1);
    cp_async_wait_ring();
    __syncwarp();             // every lane's words of this slot are in
    if (v == n1) sides_meet();
    const long long t0 = tile_row(v);
    const unsigned* s = slot(v);
    const bool phase2 = v >= n1;
    c.start(t0);
    // the window segment's checkpoint (units past the training tiles)
    float4* ckj = ck + (size_t)(v < nA ? 0 : (t0 - row0) / GROUP) * 2 * PPB;
    if (side == 0) {
      if (v >= nA && !phase2) put8<Op>(ckj, PPB, alpha);
      if (phase2) {
        // the segment's betas from the beta side's checkpoint
        get8<Op>(ckj, PPB, beta);
#pragma unroll
        for (int q = GROUP - 1; q >= 0; --q) {
          V g00, g01;
          split_gammas<Op>(s, q, t0 + q, rows, c, &g00, &g01);
#pragma unroll
          for (int m = 0; m < 8; ++m) mk[q][m] = beta[m];
          beta_step<Op>(beta, g00, g01);
        }
      }
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        V g00, g01, br0[8], br1[8];
        split_gammas<Op>(s, q, t0 + q, rows, c, &g00, &g01);
        branches<Op>(alpha, g00, g01, br0, br1);
        if (phase2)
          c.store(llr, (size_t)(t0 + q),
                  OpsBf16x2::bits(emit<Op>(br0, br1, mk[q])));
#pragma unroll
        for (int m = 0; m < 8; ++m)
          alpha[m] = Op::max(br0[tr_ps(m, 0)], br1[tr_ps(m, 1)]);
      }
      norm8<Op>(alpha);                       // after the group's row 7
    } else {
      if (v >= nA && !phase2) put8<Op>(ckj, PPB, beta);
      if (phase2) {
        // the segment's alphas from the alpha side's checkpoint (no row
        // of it renormalizes before its last)
        get8<Op>(ckj, PPB, alpha);
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
#pragma unroll
          for (int m = 0; m < 8; ++m) mk[q][m] = alpha[m];
          if (q + 1 < GROUP) {
            V g00, g01, br0[8], br1[8];
            split_gammas<Op>(s, q, t0 + q, rows, c, &g00, &g01);
            branches<Op>(alpha, g00, g01, br0, br1);
#pragma unroll
            for (int m = 0; m < 8; ++m)
              alpha[m] = Op::max(br0[tr_ps(m, 0)], br1[tr_ps(m, 1)]);
          }
        }
      }
#pragma unroll
      for (int q = GROUP - 1; q >= 0; --q) {
        V g00, g01;
        split_gammas<Op>(s, q, t0 + q, rows, c, &g00, &g01);
        if (phase2) {
          V br0[8], br1[8];
          branches<Op>(mk[q], g00, g01, br0, br1);
          c.store(llr, (size_t)(t0 + q),
                  OpsBf16x2::bits(emit<Op>(br0, br1, beta)));
        }
        beta_step<Op>(beta, g00, g01);
      }
      norm8<Op>(beta);                        // after the group's row 0
    }
  }
  if (n1 == nunit) sides_meet();   // the beta side of a one-segment window
}

// shared bytes of a split block (must equal ops/fec/turbo_win.py
// win_plan): 32 B per segment checkpoint and pair, and each side's ring
// of NSLOT tiles of 8 rows x 2 staged rows of rw words
static size_t win_split_smem_bytes(int l, int rw) {
  return (size_t)(l / GROUP) * 2 * PPB * 16
         + 2 * (size_t)NSLOT * GROUP * 2 * rw * 4;
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

// bfloat16: the plan's kernel and columns. threads 32: the one-thread
// kernel (two code blocks per thread) with its checkpoint buffer;
// threads 64: the split kernel (ckpt is not used) on AlignedCols, or on
// ShiftedCols when `shifted`. The one-thread kernel and AlignedCols read
// pairs as aligned words: the launcher refuses them on an odd B or
// arrays off a 4-byte boundary. The plan's shared bytes follow the
// columns' staged row.
extern "C" int turbo_win_launch_bf16(const void* lsa, const void* lp,
                                     void* llr, void* ckpt, int B, int K,
                                     int L, int O, int threads, int shifted,
                                     int smem_bytes, void* stream) {
  const bool aligned_pairs = B % 2 == 0 &&
      (((uintptr_t)lsa | (uintptr_t)lp | (uintptr_t)llr |
        (uintptr_t)ckpt) & 3) == 0;
  if (!shifted && !aligned_pairs) return (int)cudaErrorInvalidValue;
  if (threads == 32) {
    if (shifted) return (int)cudaErrorInvalidValue;
    return win_launch<OpsBf16x2>(lsa, lp, llr, ckpt, B / 2, K, L, O, threads,
                                 smem_bytes, stream);
  }
  typedef const unsigned short* In;
  typedef unsigned short* Out;
  if (threads != 2 * PPB || L % GROUP != 0 || O % GROUP != 0 || O > L ||
      K % L != 0 || B < 1 ||
      (size_t)smem_bytes != win_split_smem_bytes(
          L, shifted ? ShiftedCols::RW : AlignedCols::RW))
    return (int)cudaErrorInvalidValue;
  const int pairs = (B + 1) / 2;
  const dim3 grid((unsigned)((pairs + PPB - 1) / PPB), (unsigned)(K / L));
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (!shifted) {
    e = cudaFuncSetAttribute(win_split_kernel<OpsBf16x2, AlignedCols>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    win_split_kernel<OpsBf16x2, AlignedCols><<<grid, threads, smem_bytes,
                                               st>>>(
        (In)lsa, (In)lp, (Out)llr, B, K, L, O);
  } else {
    e = cudaFuncSetAttribute(win_split_kernel<OpsBf16x2, ShiftedCols>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    win_split_kernel<OpsBf16x2, ShiftedCols><<<grid, threads, smem_bytes,
                                               st>>>(
        (In)lsa, (In)lp, (Out)llr, B, K, L, O);
  }
  return (int)cudaGetLastError();
}
