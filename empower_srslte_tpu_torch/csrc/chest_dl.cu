// Downlink CRS channel estimate and pilot noise estimate, sm_90a.
//
// Replaces no TPU kernel: the JAX package's chest (empower_srslte_tpu/
// ops/chest.py chest_dl, noise_est_pilots) is plain jnp that XLA fuses.
// In eager PyTorch the same estimate is a loop of tiny ops (the LS
// product, the FIR, four comb rows of frequency interpolation, fourteen
// per-symbol time sums), some 540 launches for the four (rx, port)
// estimates and the noise of one receiver call, whatever the batch; this
// kernel does all of it in one launch. It computes what the plain twin
// (ops/chest.py _chest_dl_plain, _noise_est_plain) computes, operation
// for operation in float32 (no contraction: --fmad=false): the LS estimate
// y * conj(r) at the pilots (chest_dl.c:641-663), the FIR along each
// pilot row with edge replication (the 3-tap default, a Gaussian of up to
// 5 taps, or [1] for none), linear frequency interpolation of each comb
// row with linear extrapolation at both edges, and linear time
// interpolation between at most two pilot rows per symbol
// (interpolate_pilots, chest_dl.c:365-446); and the noise as
// E|h_ls - smooth3(h_ls)|^2 * 3/2 (estimate_noise_pilots,
// chest_dl.c:268-329), whose sum runs in another order than the twin's.
//
// What bounds it. The estimate h [N, P, S, K] complex64 is written once:
// at the 20 MHz receiver's batch of 256 subframes x 2 rx x 2 ports that is
// 137.6 MB, 0.041 ms at 3.35 TB/s; the pilots read are 1/21 of that. A
// few operations per output (two interpolations, a weighted sum): bytes-
// bound.
//
// Design. One block per (n = subframe x rx, port), split over symbols
// (gridDim.y) when there are too few of those to fill the card (a TTI's
// 2 x 2). Each block gathers its port's pilot rows from the grid, forms
// the LS estimate and its FIR in shared memory (4 rows x 2 nof_prb
// complex each), and the first block of a (n, port) reduces the noise
// residual in the same pass. Then each comb row that the block's symbols
// read is interpolated to every subcarrier once, into the LS estimate's
// place (4 x 1200 complex, 38.4 KB at 100 PRB: the block's shared memory
// is 44.8 KB), so that the divisions of the interpolation weights run
// once a row and not once an output. Last, every (symbol, subcarrier) of
// the block is written directly, two subcarriers a thread as one 16-byte
// store: the symbol's one or two time weights on those rows. No
// intermediate leaves the block. The tables (pilot symbols, comb
// offsets, conjugate pilots, the time weights' rows and values) come from
// the port's static plan (ops/chest.py kernel_tables), so one kernel
// serves every bandwidth, port, subframe and cyclic prefix.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_TAPS 5
#define MAX_ROWS 4   // CRS pilot rows of a subframe (ports 0-1)
#define MAX_SYMB 14  // OFDM symbols of a subframe (normal CP)
// the per-port meta row: rows, pilot symbols, comb offsets, then the time
// weights' first and second row per symbol (-1: none)
#define META(S) (1 + 2 * MAX_ROWS + 2 * (S))

struct Taps {
  float t[MAX_TAPS];  // the estimate's FIR
  float nt[3];        // the noise estimate's 3-tap smooth
  int n;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 scale(float w, float2 a) {
  return make_float2(w * a.x, w * a.y);
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// one comb row (pilots at off + 6m, m < M) at subcarrier k: interior
// phases d/6 between neighbours, linear extrapolation from the first and
// the last two pilots at the edges (ops/chest.py _freq_interp_row)
__device__ __forceinline__ float2 freq_interp(const float2* hs, int off,
                                              int M, int k) {
  const int j = k - off;
  int m;
  float w;
  if (j < 0) {
    m = 0;
    w = (float)j / 6.0f;
  } else if (j < 6 * (M - 1)) {
    m = j / 6;
    w = (float)(j - 6 * m) / 6.0f;
  } else {
    m = M - 2;
    w = (float)j / 6.0f - (float)(M - 2);
  }
  const float u = 1.0f - w;
  return add(scale(u, hs[m]), scale(w, hs[m + 1]));
}

__global__ void __launch_bounds__(THREADS)
    chest_dl_kernel(const float2* __restrict__ grid,
                    const float2* __restrict__ cv,
                    const int* __restrict__ meta,
                    const float2* __restrict__ tw, const Taps taps,
                    float2* __restrict__ h, float* __restrict__ noise, int P,
                    int S, int K, int M) {
  extern __shared__ float4 smem4[];
  float2* hs = reinterpret_cast<float2*>(smem4);  // [MAX_ROWS * M] FIR'd
  // [MAX_ROWS * M] the LS estimate, then [MAX_ROWS * K] each comb row
  // interpolated to every subcarrier
  float2* ls = hs + MAX_ROWS * M;
  float2* hf = ls;
  __shared__ int s_ra[MAX_SYMB], s_rb[MAX_SYMB], s_off[MAX_ROWS];
  __shared__ float s_wa[MAX_SYMB], s_wb[MAX_SYMB];
  __shared__ float red[THREADS / 32];

  const int np = blockIdx.x;           // n * P + port
  const int pi = np % P;
  const int n = np / P;
  const int* pm = meta + (size_t)pi * META(S);
  const int R = pm[0];
  const int RM = R * M;
  const float2* g = grid + (size_t)n * S * K;
  const float2* c = cv + (size_t)pi * MAX_ROWS * M;

  if ((int)threadIdx.x < S) {
    const int s = threadIdx.x;
    const float2 w = tw[(size_t)pi * S + s];
    s_ra[s] = pm[1 + 2 * MAX_ROWS + s];
    s_rb[s] = pm[1 + 2 * MAX_ROWS + S + s];
    s_wa[s] = w.x;
    s_wb[s] = w.y;
  }
  if ((int)threadIdx.x < R)
    s_off[threadIdx.x] = pm[1 + MAX_ROWS + threadIdx.x];
  for (int i = threadIdx.x; i < RM; i += THREADS) {
    const int r = i / M, m = i - r * M;
    ls[i] = cmul(g[(size_t)pm[1 + r] * K + pm[1 + MAX_ROWS + r] + 6 * m],
                 c[r * M + m]);
  }
  __syncthreads();

  const bool do_noise = noise != nullptr && blockIdx.y == 0;
  const int half = (taps.n - 1) / 2;
  float nacc = 0.0f;
  for (int i = threadIdx.x; i < RM; i += THREADS) {
    const int r = i / M, m = i - r * M;
    const float2* row = ls + r * M;
    float2 acc = scale(taps.t[0], row[min(max(m - half, 0), M - 1)]);
#pragma unroll
    for (int t = 1; t < MAX_TAPS; ++t)
      if (t < taps.n)
        acc = add(acc,
                  scale(taps.t[t], row[min(max(m + t - half, 0), M - 1)]));
    hs[i] = acc;
    if (do_noise) {
      const float2 sm = add(add(scale(taps.nt[0], row[max(m - 1, 0)]),
                                scale(taps.nt[1], row[m])),
                            scale(taps.nt[2], row[min(m + 1, M - 1)]));
      const float rx = row[m].x - sm.x, ry = row[m].y - sm.y;
      nacc += rx * rx + ry * ry;
    }
  }
  if (do_noise) {
    for (int o = 16; o > 0; o >>= 1)
      nacc += __shfl_down_sync(0xffffffffu, nacc, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = nacc;
  }
  __syncthreads();
  if (do_noise && threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) sum += red[w];
    noise[np] = sum / (float)RM * 1.5f;
  }
  if (h == nullptr) return;

  // the comb rows this block's symbols s = blockIdx.y + j * gridDim.y
  // read, each interpolated to every subcarrier once (ls is dead)
  const int ys = blockIdx.y, gy = gridDim.y;
  unsigned need = 0;
  for (int s = ys; s < S; s += gy) {
    if (s_ra[s] >= 0) need |= 1u << s_ra[s];
    if (s_rb[s] >= 0) need |= 1u << s_rb[s];
  }
  for (int r = 0; r < R; ++r)
    if (need >> r & 1u)
      for (int k = threadIdx.x; k < K; k += THREADS)
        hf[r * K + k] = freq_interp(hs + r * M, s_off[r], M, k);
  __syncthreads();

  // every (symbol, subcarrier) of the block: the symbol's time weights on
  // one or two rows, two subcarriers a thread and a 16-byte store
  const int K2 = K >> 1;
  const int nsym = (S - ys + gy - 1) / gy;
  const float4* hf4 = reinterpret_cast<const float4*>(hf);
  float4* out = reinterpret_cast<float4*>(h + (size_t)np * S * K);
  int js = threadIdx.x / K2, k2 = threadIdx.x - js * K2;
  while (js < nsym) {
    const int s = ys + js * gy;
    const int ra = s_ra[s], rb = s_rb[s];
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ra >= 0) {
      const float wa = s_wa[s];
      const float4 a = hf4[ra * K2 + k2];
      v = make_float4(wa * a.x, wa * a.y, wa * a.z, wa * a.w);
      if (rb >= 0) {
        const float wb = s_wb[s];
        const float4 b = hf4[rb * K2 + k2];
        v = make_float4(v.x + wb * b.x, v.y + wb * b.y, v.z + wb * b.z,
                        v.w + wb * b.w);
      }
    }
    out[(size_t)s * K2 + k2] = v;
    k2 += THREADS;
    while (k2 >= K2) {
      k2 -= K2;
      ++js;
    }
  }
}

// One launch over N = (subframes x rx) grids [S, K] and P ports.
// grid [N, S, K], cv [P, MAX_ROWS, M] complex64; meta [P, META(S)] int32;
// tw [P, S, 2] float32; taps_host: MAX_TAPS FIR taps (ntaps used), then
// the noise's 3; h [N, P, S, K] complex64 (NULL: the noise alone); noise
// [N, P] float32; split blocks per (n, port) over symbols. Returns the
// launch's CUDA error.
extern "C" int chest_dl_launch(const void* grid, const void* cv,
                               const int* meta, const void* tw,
                               const float* taps_host, int ntaps, void* h,
                               float* noise, int N, int P, int S, int K,
                               int M, int split, void* stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || N < 1 || P < 1 || S < 1 ||
      S > MAX_SYMB || K < 2 || (K & 1) || M < 2 || split < 1 || split > S ||
      noise == nullptr)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < MAX_TAPS; ++i) taps.t[i] = i < ntaps ? taps_host[i] : 0.0f;
  for (int i = 0; i < 3; ++i) taps.nt[i] = taps_host[MAX_TAPS + i];
  taps.n = ntaps;
  // the FIR'd pilots, and the LS pilots or the interpolated rows: 44.8 KB
  // at 100 PRB, under the 48 KB a block takes without opting in
  const size_t smem = MAX_ROWS * (size_t)(M + (K > M ? K : M)) * sizeof(float2);
  const dim3 blocks(N * P, h == nullptr ? 1 : split);
  chest_dl_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)grid, (const float2*)cv, meta, (const float2*)tw, taps,
      (float2*)h, noise, P, S, K, M);
  return (int)cudaGetLastError();
}
