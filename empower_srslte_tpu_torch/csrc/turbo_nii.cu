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
//
// bfloat16 (launcher turbo_nii_launch_bf16). The JAX kernel takes its
// dtype from its input, and its decoder feeds it bfloat16 by default
// (turbo_decoder.py:453); every add, subtraction, max and halving then
// rounds to bfloat16. Both bfloat16 kernels hold two neighbouring code
// blocks in one bf16x2 register (code block 2j in the low half) and run
// add/sub/mul.rn.bf16x2 and max/neg.bf16x2 in the JAX kernel's order: one
// rounding per operation, no FMA, no float intermediate (a-priori add at
// staging, (u+p)*0.5 and (u-p)*0.5, branch sums then the beta add,
// (tot0 - tot1) - u as two roundings, renormalization as v - max). The
// boundary metric is bf16(-1e30), which g cannot move. The plan
// (ops/fec/turbo_nii.py nii_plan) picks the kernel by the launch's shape:
//
// * One-thread kernel (nii_kernel<OpsBf16x2>): the float32 schedule above
//   with a code block pair per thread, for an even batch on 4-byte
//   aligned arrays above one wave of split blocks (five per SM at the
//   main shape's window; the plan counts the card's SMs; the crossover
//   was timed between 4.4 and 5.1 a SM). What bounds it: not
//   bytes (with the forward sweep re-reading nothing from device memory
//   it is 5 % faster) but the rate at which its 8 warps per SM (shared
//   memory and 186 registers) get their arithmetic issued: its time
//   halves with the batch down to one wave, so a design with more
//   instructions per code block loses there (PERF.md section 6).
// * Split kernel (nii_split_kernel<OpsBf16x2, APR, Cols>): below that, a
//   launch is latency-bound (few warps, each a chain of three passes over
//   the window), so each window of a code block pair gets two threads in
//   two warps of one block: the alpha side runs alpha up the lower half
//   of the segments while the beta side runs beta down the upper half,
//   each keeping the carry entering every segment in shared memory; they
//   meet at a named barrier, then each crosses into the other's half,
//   recomputing the other recursion's segment from its checkpoint and
//   emitting. A thread's chain is about 55 % of the one-thread kernel's.
//   The split kernel also takes any batch: with an odd B, or arrays off a
//   4-byte boundary, a lane's pair may straddle two aligned words, so a
//   row's 32 pairs are staged as the 33 words they span and each lane
//   picks its pair with one byte permute (ShiftedCols, 1.2-1.5x the time
//   of the one-word AlignedCols, which the plan takes wherever it can);
//   the missing half of an odd batch's last pair is never stored. Its
//   segments are 8 rows (half the renormalization group; 164 registers):
//   with 16 the recomputed metrics took it to 255 registers and spills
//   and it ran 5-25 % slower, so 16 serve only a window too long for the
//   8-row checkpoints (a bfloat16 decode with no window, l >= 1696).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e30f)
// rows per segment: the renormalization group
#define SEG 16
// slots of the input ring
#define NSLOT 2

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
  // the 4 bytes of a metric as a float (for 16-byte shared stores)
  static __device__ __forceinline__ float pack(T a) { return a; }
  static __device__ __forceinline__ T unpack(float a) { return a; }
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

// (u + p) * 0.5 and (u - p) * 0.5
template <class Op>
__device__ __forceinline__ void gammas(typename Op::T uu, typename Op::T pp,
                                       typename Op::T* g00,
                                       typename Op::T* g01) {
  *g00 = Op::half(Op::add(uu, pp));
  *g01 = Op::half(Op::sub(uu, pp));
}

// 8 metrics <-> two float4 of a [n][2][T] shared array (thread fastest);
// a metric is 4 bytes in both types
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

// staged row i of a slot: uu = u (+ apr), pp = p
template <class Op, bool APR>
__device__ __forceinline__ void stage_row(const typename Op::T* s, int i,
                                          int T, typename Op::T* uu,
                                          typename Op::T* pp) {
  constexpr int NIN = APR ? 3 : 2;
  const typename Op::T* q = s + (size_t)i * NIN * T;
  typename Op::T x = q[0];
  if (APR) x = Op::add(x, q[2 * T]);
  *uu = x;
  *pp = q[T];
}

// N backward steps over a staged segment, rows N-1 .. 0; with STORE the
// carry entering each row goes to the segment buffer
template <class Op, bool APR, int N, bool STORE>
__device__ __forceinline__ void seg_backward(typename Op::T* beta,
                                             const typename Op::T* s,
                                             typename Op::T (*bk)[8],
                                             int T) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    typename Op::T uu, pp, g00, g01;
    stage_row<Op, APR>(s, i, T, &uu, &pp);
    if (STORE) {
#pragma unroll
      for (int m = 0; m < 8; ++m) bk[i][m] = beta[m];
    }
    gammas<Op>(uu, pp, &g00, &g01);
    beta_step<Op>(beta, g00, g01);
  }
}

// N forward steps over a staged segment starting at window row r0:
// alpha recursion and the extrinsic emission
template <class Op, bool APR, int N>
__device__ __forceinline__ void seg_forward(typename Op::T* alpha,
                                            const typename Op::T* s,
                                            const typename Op::T (*bk)[8],
                                            int T, typename Op::T* ext_col,
                                            int B, int r0, int l) {
  typedef typename Op::T V;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    V uu, pp, g00, g01;
    stage_row<Op, APR>(s, i, T, &uu, &pp);
    gammas<Op>(uu, pp, &g00, &g01);
    const V* bk1 = bk[i];
    V br0[8], br1[8];
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      br0[st] = Op::add(alpha[st], gsel<Op>(g00, g01, 0, tr_par(st, 0)));
      br1[st] = Op::add(alpha[st], gsel<Op>(g00, g01, 1, tr_par(st, 1)));
    }
    V tot0 = Op::add(br0[0], bk1[tr_ns(0, 0)]);
    V tot1 = Op::add(br1[0], bk1[tr_ns(0, 1)]);
#pragma unroll
    for (int st = 1; st < 8; ++st) {
      tot0 = Op::max(tot0, Op::add(br0[st], bk1[tr_ns(st, 0)]));
      tot1 = Op::max(tot1, Op::add(br1[st], bk1[tr_ns(st, 1)]));
    }
    ext_col[(size_t)i * B] = Op::sub(Op::sub(tot0, tot1), uu);
#pragma unroll
    for (int st = 0; st < 8; ++st)
      alpha[st] = Op::max(br0[tr_ps(st, 0)], br1[tr_ps(st, 1)]);
    const int r = r0 + i;
    if ((r & 15) == 15 || r == l - 1) norm8<Op>(alpha);
  }
}

// B: columns of the [K, B] arrays in units of Op::T (code blocks in
// float32, code block pairs in bf16x2)
template <class Op, bool APR>
__global__ void __launch_bounds__(32) nii_kernel(
    const typename Op::T* __restrict__ u, const typename Op::T* __restrict__ p,
    const typename Op::T* __restrict__ apr,
    const typename Op::T* __restrict__ tail_u,
    const typename Op::T* __restrict__ tail_p,
    const typename Op::T* __restrict__ a_st,
    const typename Op::T* __restrict__ b_st, typename Op::T* __restrict__ ext,
    typename Op::T* __restrict__ a_next, typename Op::T* __restrict__ b_next,
    int B, int l, int W, int first_w, int last_w) {
  typedef typename Op::T V;
  constexpr int NIN = APR ? 3 : 2;
  extern __shared__ float4 smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int b = blockIdx.x * T + t;
  const int w = blockIdx.y;
  if (b >= B) return;
  const int nseg = (l + SEG - 1) / SEG;
  const int nunit = 2 * nseg - 1;
  const V zero = Op::lit(0.0f), neg = Op::lit(NEG);
  float4* ck = smem + t;                                  // [nseg-1][2][T]
  V* ring = reinterpret_cast<V*>(smem + (size_t)(nseg - 1) * 2 * T)
            + t;                                     // [NSLOT][SEG][NIN][T]
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
      V* d = slot(v);
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
  V beta[8];
  if (w == last_w) {
#pragma unroll
    for (int s = 0; s < 8; ++s) beta[s] = s == 0 ? zero : neg;
    for (int j = 2; j >= 0; --j) {
      V g00, g01;
      gammas<Op>(tail_u[(size_t)j * B + b], tail_p[(size_t)j * B + b], &g00,
                 &g01);
      beta_step<Op>(beta, g00, g01);
    }
    norm8<Op>(beta);
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s)
      beta[s] = b_st[((size_t)(w + 1) * 8 + s) * B + b];
  }

  V alpha[8], bk[SEG][8];
  for (int v = 0; v < nunit; ++v) {
    load(v + NSLOT - 1);
    cp_async_wait_ring();
    const int j = seg_of(v);
    const int r0 = j * SEG;
    const bool full = l - r0 >= SEG;   // else the 8-row top segment
    const V* s = slot(v);
    if (v < nseg) {
      // ---- backward sweep over segment j (renorm after its row r0) ----
      if (j > 0) {
        put8<Op>(ck + (size_t)(j - 1) * 2 * T, T, beta);
        if (full) seg_backward<Op, APR, SEG, false>(beta, s, bk, T);
        else      seg_backward<Op, APR, SEG / 2, false>(beta, s, bk, T);
        norm8<Op>(beta);
        continue;
      }
      seg_backward<Op, APR, SEG, true>(beta, s, bk, T);
      norm8<Op>(beta);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        b_next[((size_t)w * 8 + q) * B + b] = beta[q];
        if (w == W - 1) b_next[((size_t)W * 8 + q) * B + b] = zero;
      }
      if (w == first_w) {
#pragma unroll
        for (int q = 0; q < 8; ++q) alpha[q] = q == 0 ? zero : neg;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          alpha[q] = a_st[((size_t)w * 8 + q) * B + b];
      }
    } else {
      // ---- recompute segment j's betas from its checkpoint ----
      get8<Op>(ck + (size_t)(j - 1) * 2 * T, T, beta);
      if (full) seg_backward<Op, APR, SEG, true>(beta, s, bk, T);
      else      seg_backward<Op, APR, SEG / 2, true>(beta, s, bk, T);
    }
    // ---- forward sweep + extrinsic emission over segment j ----
    V* ext_col = ext + (row0 + r0) * B + b;
    if (full) seg_forward<Op, APR, SEG>(alpha, s, bk, T, ext_col, B, r0, l);
    else      seg_forward<Op, APR, SEG / 2>(alpha, s, bk, T, ext_col, B, r0,
                                            l);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a_next[((size_t)(w + 1) * 8 + s) * B + b] = alpha[s];
    if (w == 0) a_next[(size_t)s * B + b] = zero;
  }
}

// ---------------------------------------------------------------------
// bfloat16: the split kernel (nii_split_kernel<OpsBf16x2, APR, Cols, SEGR>)
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


// code blocks 2j (low half) and 2j+1 (high half; zero when hi is false)
// of a bfloat16 array at element e = row * B + 2j, at any alignment
__device__ __forceinline__ unsigned ld_pair(const unsigned short* base,
                                            size_t e, bool hi) {
  const unsigned short* a = base + e;
  if (hi && ((uintptr_t)a & 3) == 0)
    return *reinterpret_cast<const unsigned*>(a);
  return (unsigned)a[0] | (hi ? (unsigned)a[1] << 16 : 0u);
}
__device__ __forceinline__ void st_pair(unsigned short* base, size_t e,
                                        unsigned v, bool hi) {
  unsigned short* a = base + e;
  if (hi && ((uintptr_t)a & 3) == 0) {
    *reinterpret_cast<unsigned*>(a) = v;
  } else {
    a[0] = (unsigned short)v;
    if (hi) a[1] = (unsigned short)(v >> 16);
  }
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

// staged row i of a slot: uu = u (+ apr), pp = p
template <class Op, bool APR, class C>
__device__ __forceinline__ void split_row(const unsigned* s, int i,
                                          const C& c,
                                          typename Op::T* uu,
                                          typename Op::T* pp) {
  constexpr int NIN = APR ? 3 : 2;
  const unsigned* q = s + i * NIN * C::RW;
  typename Op::T x = OpsBf16x2::of(c.pair(q, i, 0));
  if (APR) x = Op::add(x, OpsBf16x2::of(c.pair(q + 2 * C::RW, i, 2)));
  *uu = x;
  *pp = OpsBf16x2::of(c.pair(q + C::RW, i, 1));
}

// the branch sums alpha + g(0, .) and alpha + g(1, .) of every state
template <class Op>
__device__ __forceinline__ void branches(const typename Op::T* alpha,
                                         typename Op::T g00,
                                         typename Op::T g01,
                                         typename Op::T* br0,
                                         typename Op::T* br1) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    br0[s] = Op::add(alpha[s], gsel<Op>(g00, g01, 0, tr_par(s, 0)));
    br1[s] = Op::add(alpha[s], gsel<Op>(g00, g01, 1, tr_par(s, 1)));
  }
}

// the next alphas from the branch sums
template <class Op>
__device__ __forceinline__ void alpha_from(typename Op::T* alpha,
                                           const typename Op::T* br0,
                                           const typename Op::T* br1) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
    alpha[s] = Op::max(br0[tr_ps(s, 0)], br1[tr_ps(s, 1)]);
}

// the extrinsic of one row from its branch sums, the beta entering it
// (the backward carry before the row's step) and uu, in the JAX kernel's
// order: (alpha + g) + beta, the maxima, (tot0 - tot1) - uu
template <class Op>
__device__ __forceinline__ typename Op::T emit(const typename Op::T* br0,
                                               const typename Op::T* br1,
                                               const typename Op::T* beta,
                                               typename Op::T uu) {
  typename Op::T tot0 = Op::add(br0[0], beta[tr_ns(0, 0)]);
  typename Op::T tot1 = Op::add(br1[0], beta[tr_ns(0, 1)]);
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    tot0 = Op::max(tot0, Op::add(br0[s], beta[tr_ns(s, 0)]));
    tot1 = Op::max(tot1, Op::add(br1[s], beta[tr_ns(s, 1)]));
  }
  return Op::sub(Op::sub(tot0, tot1), uu);
}

// alpha side: N forward steps over a segment from window row r0 (trellis
// row g0), with the emission against the stored betas mk when EMIT
template <class Op, bool APR, int N, bool EMIT, class C>
__device__ __forceinline__ void split_fwd(typename Op::T* alpha,
                                          const unsigned* s,
                                          const typename Op::T (*mk)[8],
                                          const C& c, int r0, size_t g0,
                                          int l, unsigned short* ext) {
  typedef typename Op::T V;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = r0 + i;
    V uu, pp, g00, g01;
    split_row<Op, APR>(s, i, c, &uu, &pp);
    gammas<Op>(uu, pp, &g00, &g01);
    V br0[8], br1[8];
    branches<Op>(alpha, g00, g01, br0, br1);
    if (EMIT)
      c.store(ext, g0 + i, OpsBf16x2::bits(emit<Op>(br0, br1, mk[i], uu)));
    alpha_from<Op>(alpha, br0, br1);
    if ((r & 15) == 15 || r == l - 1) norm8<Op>(alpha);
  }
}

// the alphas entering each of a segment's N rows into mk (the beta
// side's recompute: no row of it renormalizes before its last)
template <class Op, bool APR, int N, class C>
__device__ __forceinline__ void split_fwd_store(typename Op::T* alpha,
                                                const unsigned* s,
                                                typename Op::T (*mk)[8],
                                                const C& c, size_t g0) {
  typedef typename Op::T V;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) mk[i][q] = alpha[q];
    if (i + 1 < N) {
      V uu, pp, g00, g01;
      split_row<Op, APR>(s, i, c, &uu, &pp);
      gammas<Op>(uu, pp, &g00, &g01);
      V br0[8], br1[8];
      branches<Op>(alpha, g00, g01, br0, br1);
      alpha_from<Op>(alpha, br0, br1);
    }
  }
}

// beta side: N backward steps over a segment from its top row down; with
// STORE the carry entering each row goes to mk (the alpha side's
// recompute), with EMIT each row emits against the alphas in mk
template <class Op, bool APR, int N, bool STORE, bool EMIT, class C>
__device__ __forceinline__ void split_bwd(typename Op::T* beta,
                                          const unsigned* s,
                                          typename Op::T (*mk)[8],
                                          const C& c, size_t g0,
                                          unsigned short* ext) {
  typedef typename Op::T V;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    V uu, pp, g00, g01;
    split_row<Op, APR>(s, i, c, &uu, &pp);
    gammas<Op>(uu, pp, &g00, &g01);
    if (STORE) {
#pragma unroll
      for (int q = 0; q < 8; ++q) mk[i][q] = beta[q];
    }
    if (EMIT) {
      V br0[8], br1[8];
      branches<Op>(mk[i], g00, g01, br0, br1);
      c.store(ext, g0 + i, OpsBf16x2::bits(emit<Op>(br0, br1, beta, uu)));
    }
    beta_step<Op>(beta, g00, g01);
  }
}

// The split schedule: a block holds PPB code block pairs of one window in
// two warps. The alpha side (warp 0) runs alpha up the window's lower h
// segments and the beta side (warp 1) beta down the upper nseg - h, each
// keeping the carry entering every segment (a checkpoint, in shared
// memory). They meet; then the alpha side walks the upper segments
// upwards, recomputing each one's betas from the beta side's checkpoint
// and emitting, while the beta side walks the lower segments downwards,
// recomputing each one's alphas from the alpha side's checkpoint and
// emitting. Every alpha and beta is the one the JAX kernel's single
// backward-then-forward sweep computes (the same adds from the same
// carries; renormalization by row), so the result is bit-identical.
template <class Op, bool APR, class C, int SEGR>
__global__ void __launch_bounds__(2 * PPB) nii_split_kernel(
    const unsigned short* __restrict__ u,
    const unsigned short* __restrict__ p,
    const unsigned short* __restrict__ apr,
    const unsigned short* __restrict__ tail_u,
    const unsigned short* __restrict__ tail_p,
    const unsigned short* __restrict__ a_st,
    const unsigned short* __restrict__ b_st,
    unsigned short* __restrict__ ext, unsigned short* __restrict__ a_next,
    unsigned short* __restrict__ b_next, int B, int l, int W, int first_w,
    int last_w) {
  typedef typename Op::T V;
  constexpr int NIN = APR ? 3 : 2;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, side = threadIdx.x >> 5;
  const int jb = blockIdx.x * PPB;
  const int w = blockIdx.y;
  C c;
  c.lane = lane;
  c.B = B;
  c.live = 2 * (jb + lane) < B;
  c.hi = 2 * (jb + lane) + 1 < B;
  c.col = 2 * (size_t)(jb + lane);
  set_shift(c, jb, (((uintptr_t)u >> 1) & 1) |
                       ((((uintptr_t)p >> 1) & 1) << 1) |
                       (APR ? (((uintptr_t)apr >> 1) & 1) << 2 : 0));
  const size_t row0 = (size_t)w * l;
  const int nseg = (l + SEGR - 1) / SEGR;
  const int h = nseg / 2;
  const int n1 = side == 0 ? h : nseg - h;    // this side's phase-1 units
  const size_t nel = (size_t)W * l * B;
  const V zero = Op::lit(0.0f), neg = Op::lit(NEG);
  float4* ck = smem + lane;                                // [nseg][2][PPB]
  unsigned* ring = reinterpret_cast<unsigned*>(smem + (size_t)nseg * 2 * PPB)
                   + (size_t)side * NSLOT * SEGR * NIN * C::RW;

  // unit v's segment: the alpha side walks 0 .. nseg-1, the beta side
  // nseg-1 .. 0; each stages every segment once
  auto seg_of = [&](int v) { return side == 0 ? v : nseg - 1 - v; };
  auto slot = [&](int v) {
    return ring + (size_t)(v % NSLOT) * SEGR * NIN * C::RW;
  };
  auto load = [&](int v) {
    if (v < nseg) {
      const int r0 = seg_of(v) * SEGR, n = min(SEGR, l - r0);
      unsigned* d = slot(v);
      for (int i = 0; i < n; ++i, d += NIN * C::RW) {
        const size_t row = row0 + r0 + i;
        c.stage(d, u, row, nel);
        c.stage(d + C::RW, p, row, nel);
        if (APR) c.stage(d + 2 * C::RW, apr, row, nel);
      }
    }
    cp_async_commit();
  };
  for (int v = 0; v < NSLOT - 1; ++v) load(v);

  V alpha[8], beta[8];
  if (side == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      alpha[q] = w == first_w ? (q == 0 ? zero : neg)
                 : OpsBf16x2::of(c.live ? ld_pair(a_st, ((size_t)w * 8 + q)
                                                  * B + c.col, c.hi)
                                        : 0u);
  } else if (w == last_w) {
#pragma unroll
    for (int q = 0; q < 8; ++q) beta[q] = q == 0 ? zero : neg;
    for (int t = 2; t >= 0; --t) {
      V g00, g01;
      const size_t e = (size_t)t * B + c.col;
      gammas<Op>(OpsBf16x2::of(c.live ? ld_pair(tail_u, e, c.hi) : 0u),
                 OpsBf16x2::of(c.live ? ld_pair(tail_p, e, c.hi) : 0u),
                 &g00, &g01);
      beta_step<Op>(beta, g00, g01);
    }
    norm8<Op>(beta);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      beta[q] = OpsBf16x2::of(
          c.live ? ld_pair(b_st, ((size_t)(w + 1) * 8 + q) * B + c.col, c.hi)
                 : 0u);
  }

  V mk[SEGR][8];
  for (int v = 0; v < nseg; ++v) {
    __syncwarp();             // every lane is done with the slot refilled
    load(v + NSLOT - 1);
    cp_async_wait_ring();
    __syncwarp();             // every lane's words of this slot are in
    if (v == n1) sides_meet();
    const int js = seg_of(v), r0 = js * SEGR;
    const size_t g0 = row0 + r0;
    // else the 8-row top segment of a 16-row schedule
    const bool full = SEGR == 8 || l - r0 >= SEGR;
    const unsigned* s = slot(v);
    c.start((long long)g0);
    float4* ckj = ck + (size_t)js * 2 * PPB;
    if (side == 0) {
      if (v < n1) {
        put8<Op>(ckj, PPB, alpha);
        if (full) split_fwd<Op, APR, SEGR, false>(alpha, s, mk, c, r0, g0, l,
                                                  ext);
        else split_fwd<Op, APR, SEGR / 2, false>(alpha, s, mk, c, r0, g0, l,
                                                 ext);
      } else {
        get8<Op>(ckj, PPB, beta);
        if (full) {
          split_bwd<Op, APR, SEGR, true, false>(beta, s, mk, c, g0, ext);
          split_fwd<Op, APR, SEGR, true>(alpha, s, mk, c, r0, g0, l, ext);
        } else {
          split_bwd<Op, APR, SEGR / 2, true, false>(beta, s, mk, c, g0, ext);
          split_fwd<Op, APR, SEGR / 2, true>(alpha, s, mk, c, r0, g0, l,
                                             ext);
        }
      }
    } else {
      if (v < n1) {
        put8<Op>(ckj, PPB, beta);
        if (full) split_bwd<Op, APR, SEGR, false, false>(beta, s, mk, c, g0,
                                                         ext);
        else split_bwd<Op, APR, SEGR / 2, false, false>(beta, s, mk, c, g0,
                                                        ext);
      } else {
        get8<Op>(ckj, PPB, alpha);
        if (full) {
          split_fwd_store<Op, APR, SEGR>(alpha, s, mk, c, g0);
          split_bwd<Op, APR, SEGR, false, true>(beta, s, mk, c, g0, ext);
        } else {
          split_fwd_store<Op, APR, SEGR / 2>(alpha, s, mk, c, g0);
          split_bwd<Op, APR, SEGR / 2, false, true>(beta, s, mk, c, g0, ext);
        }
      }
      if ((r0 & 15) == 0) norm8<Op>(beta);     // after the group's row r0
    }
  }
  if (n1 == nseg) sides_meet();   // the beta side of a one-segment window
  if (!c.live) return;
  if (side == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_pair(a_next, ((size_t)(w + 1) * 8 + q) * B + c.col,
              OpsBf16x2::bits(alpha[q]), c.hi);
      if (w == 0) st_pair(a_next, (size_t)q * B + c.col, 0u, c.hi);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_pair(b_next, ((size_t)w * 8 + q) * B + c.col,
              OpsBf16x2::bits(beta[q]), c.hi);
      if (w == W - 1)
        st_pair(b_next, ((size_t)W * 8 + q) * B + c.col, 0u, c.hi);
    }
  }
}

// shared bytes of a split block with seg-row segments (must equal
// ops/fec/turbo_nii.py nii_plan): 32 B per segment checkpoint and pair,
// and each side's ring of NSLOT x seg rows x NIN staged rows of rw words
static size_t nii_split_smem_bytes(int l, bool apr, int rw, int seg) {
  const int nseg = (l + seg - 1) / seg;
  return (size_t)nseg * 2 * PPB * 16
         + 2 * (size_t)NSLOT * seg * (apr ? 3 : 2) * rw * 4;
}

// shared bytes of a block (must equal ops/fec/turbo_nii.py nii_plan): per
// thread 32 B per checkpoint and 4 B per staged value, in both types
static size_t nii_smem_bytes(int l, int threads, bool apr) {
  const int nseg = (l + SEG - 1) / SEG;
  return (size_t)threads * (32 * (size_t)(nseg - 1)
                            + 4 * (size_t)NSLOT * SEG * (apr ? 3 : 2));
}

// cols: columns of the arrays in units of Op::T
template <class Op>
static int nii_launch(const void* u, const void* p, const void* apr,
                      const void* tail_u, const void* tail_p,
                      const void* a_st, const void* b_st, void* ext,
                      void* a_next, void* b_next, int cols, int l, int W,
                      int first_w, int last_w, int threads, int smem_bytes,
                      void* stream) {
  typedef typename Op::T V;
  const bool has_apr = apr != nullptr;
  if (threads != 32 || l % 8 != 0 || l < SEG ||
      (size_t)smem_bytes != nii_smem_bytes(l, threads, has_apr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cols + threads - 1) / threads), (unsigned)W);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
#define NII_ARGS                                                          \
  (const V*)u, (const V*)p, (const V*)apr, (const V*)tail_u,              \
      (const V*)tail_p, (const V*)a_st, (const V*)b_st, (V*)ext,          \
      (V*)a_next, (V*)b_next, cols, l, W, first_w, last_w
  if (has_apr) {
    e = cudaFuncSetAttribute(nii_kernel<Op, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    nii_kernel<Op, true><<<grid, threads, smem_bytes, st>>>(NII_ARGS);
  } else {
    e = cudaFuncSetAttribute(nii_kernel<Op, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    nii_kernel<Op, false><<<grid, threads, smem_bytes, st>>>(NII_ARGS);
  }
#undef NII_ARGS
  return (int)cudaGetLastError();
}

// float32: B code blocks, one per thread
extern "C" int turbo_nii_launch(const void* u, const void* p, const void* apr,
                                const void* tail_u, const void* tail_p,
                                const void* a_st, const void* b_st, void* ext,
                                void* a_next, void* b_next, int B, int l,
                                int W, int first_w, int last_w, int threads,
                                int smem_bytes, void* stream) {
  return nii_launch<OpsF32>(u, p, apr, tail_u, tail_p, a_st, b_st, ext,
                            a_next, b_next, B, l, W, first_w, last_w,
                            threads, smem_bytes, stream);
}

// one bfloat16 split launch with the column type C and SEGR-row segments
template <class C, int SEGR>
static int nii_split_launch(const void* u, const void* p, const void* apr,
                            const void* tail_u, const void* tail_p,
                            const void* a_st, const void* b_st, void* ext,
                            void* a_next, void* b_next, int B, int l, int W,
                            int first_w, int last_w, int smem_bytes,
                            cudaStream_t st) {
  typedef const unsigned short* In;
  typedef unsigned short* Out;
  if ((size_t)smem_bytes !=
      nii_split_smem_bytes(l, apr != nullptr, C::RW, SEGR))
    return (int)cudaErrorInvalidValue;
  const int pairs = (B + 1) / 2;
  const dim3 grid((unsigned)((pairs + PPB - 1) / PPB), (unsigned)W);
  cudaError_t e;
#define SPLIT_ARGS                                                        \
  (In)u, (In)p, (In)apr, (In)tail_u, (In)tail_p, (In)a_st, (In)b_st,      \
      (Out)ext, (Out)a_next, (Out)b_next, B, l, W, first_w, last_w
  if (apr != nullptr) {
    e = cudaFuncSetAttribute(nii_split_kernel<OpsBf16x2, true, C, SEGR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    nii_split_kernel<OpsBf16x2, true, C, SEGR>
        <<<grid, 2 * PPB, smem_bytes, st>>>(SPLIT_ARGS);
  } else {
    e = cudaFuncSetAttribute(nii_split_kernel<OpsBf16x2, false, C, SEGR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    nii_split_kernel<OpsBf16x2, false, C, SEGR>
        <<<grid, 2 * PPB, smem_bytes, st>>>(SPLIT_ARGS);
  }
#undef SPLIT_ARGS
  return (int)cudaGetLastError();
}

// bfloat16: the plan's kernel and columns. threads 32: the one-thread
// kernel (two code blocks per thread; its segments are 16 rows); threads
// 64: the split kernel with seg_rows-row segments (8, or 16 where a long
// window's 8-row checkpoints would not fit) on AlignedCols, or on
// ShiftedCols when `shifted`. The one-thread kernel and AlignedCols read
// pairs as aligned words: the launcher refuses them on an odd B or
// arrays off a 4-byte boundary. The plan's shared bytes follow the
// segments and the columns' staged row.
extern "C" int turbo_nii_launch_bf16(const void* u, const void* p,
                                     const void* apr, const void* tail_u,
                                     const void* tail_p, const void* a_st,
                                     const void* b_st, void* ext,
                                     void* a_next, void* b_next, int B, int l,
                                     int W, int first_w, int last_w,
                                     int threads, int seg_rows, int shifted,
                                     int smem_bytes, void* stream) {
  const bool aligned_pairs = B % 2 == 0 &&
      (((uintptr_t)u | (uintptr_t)p | (uintptr_t)apr | (uintptr_t)ext |
        (uintptr_t)tail_u | (uintptr_t)tail_p | (uintptr_t)a_st |
        (uintptr_t)b_st | (uintptr_t)a_next | (uintptr_t)b_next) & 3) == 0;
  if (!shifted && !aligned_pairs) return (int)cudaErrorInvalidValue;
  if (threads == 32) {
    if (shifted || seg_rows != SEG) return (int)cudaErrorInvalidValue;
    return nii_launch<OpsBf16x2>(u, p, apr, tail_u, tail_p, a_st, b_st, ext,
                                 a_next, b_next, B / 2, l, W, first_w,
                                 last_w, threads, smem_bytes, stream);
  }
  if (threads != 2 * PPB || l % 8 != 0 || l < 16 || B < 1 ||
      (seg_rows != 8 && seg_rows != 16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SPLIT_LAUNCH(C, R)                                                \
  nii_split_launch<C, R>(u, p, apr, tail_u, tail_p, a_st, b_st, ext,      \
                         a_next, b_next, B, l, W, first_w, last_w,        \
                         smem_bytes, st)
  if (seg_rows == 8)
    return shifted ? SPLIT_LAUNCH(ShiftedCols, 8)
                   : SPLIT_LAUNCH(AlignedCols, 8);
  return shifted ? SPLIT_LAUNCH(ShiftedCols, 16)
                 : SPLIT_LAUNCH(AlignedCols, 16);
#undef SPLIT_LAUNCH
}
