// Recursion-rate probe: an 8-state add/max/renormalize chain shaped like
// the turbo decoder's trellis recursion, in float32, bfloat16 and int8,
// sm_90a.
//
// Replaces the TPU Pallas kernel of tools/microbench_vpu.py (bench ->
// pl.pallas_call(make_kernel(...)), :55, body :22-43), which picked the
// turbo decoder's metric type on the TPU. Per step and state s:
//   out[s] = max(m[s] + x[(s+1)%8], m[(s+3)%8] + x[s]);
//   m = out - max(out[0..7])   (maximum taken in state order)
// for `steps` steps, starting from m = x; the result is m.
//
// Design. One thread per element (float), per pair (__nv_bfloat162,
// __hadd2/__hmax2/__hsub2, each rounded to bfloat16 as torch rounds every
// bfloat16 op) or per packed word of four int8 (__vadd4/__vmaxs4/__vsub4,
// wrap-around like torch's int8). The 8 metrics and 8 inputs live in
// registers and the step loop runs inside the kernel, so the kernel does
// 39 operations per element and step against one read of the input and
// one write of the result: at thousands of steps it is bound by the
// operation rate, which is what it measures. Layout [8][n] state-major, packed along n.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct OpsF32 {
  typedef float T;
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T max(T a, T b) { return fmaxf(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
};

struct OpsBf16x2 {
  typedef __nv_bfloat162 T;
  static __device__ __forceinline__ T add(T a, T b) { return __hadd2(a, b); }
  static __device__ __forceinline__ T max(T a, T b) { return __hmax2(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub2(a, b); }
};

struct OpsI8x4 {
  typedef unsigned int T;
  static __device__ __forceinline__ T add(T a, T b) { return __vadd4(a, b); }
  static __device__ __forceinline__ T max(T a, T b) { return __vmaxs4(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __vsub4(a, b); }
};

template <class Ops>
__global__ void __launch_bounds__(256) probe_kernel(
    const typename Ops::T* __restrict__ x, typename Ops::T* __restrict__ out,
    long long n, int steps) {
  typedef typename Ops::T T;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n) return;
  T xs[8], ms[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    xs[s] = x[(size_t)s * n + tid];
    ms[s] = xs[s];
  }
  for (int i = 0; i < steps; ++i) {
    T o[8];
#pragma unroll
    for (int s = 0; s < 8; ++s)
      o[s] = Ops::max(Ops::add(ms[s], xs[(s + 1) & 7]),
                      Ops::add(ms[(s + 3) & 7], xs[s]));
    T m = o[0];
#pragma unroll
    for (int s = 1; s < 8; ++s) m = Ops::max(m, o[s]);
#pragma unroll
    for (int s = 0; s < 8; ++s) ms[s] = Ops::sub(o[s], m);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) out[(size_t)s * n + tid] = ms[s];
}

template <class Ops>
static int launch(const void* x, void* out, long long n, int steps,
                  void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  probe_kernel<Ops><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const typename Ops::T*)x, (typename Ops::T*)out, n, steps);
  return (int)cudaGetLastError();
}

// n: packed words per state (elements, element pairs, groups of four)
extern "C" int recursion_f32_launch(const void* x, void* out, long long n,
                                    int steps, void* stream) {
  return launch<OpsF32>(x, out, n, steps, stream);
}
extern "C" int recursion_bf16_launch(const void* x, void* out, long long n,
                                     int steps, void* stream) {
  return launch<OpsBf16x2>(x, out, n, steps, stream);
}
extern "C" int recursion_i8_launch(const void* x, void* out, long long n,
                                   int steps, void* stream) {
  return launch<OpsI8x4>(x, out, n, steps, stream);
}
