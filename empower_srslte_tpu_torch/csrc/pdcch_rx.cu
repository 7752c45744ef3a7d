// The downlink control stages of a receiver call, sm_90a: the PCFICH
// decode and the PDCCH region's LLRs (ctrl_llr_kernel), then the PDCCH
// blind search over every candidate and DCI size (pdcch_blind_kernel).
//
// What they replace. The blind search's tail-biting Viterbi decodes what
// the TPU kernel viterbi_regs_pallas (empower_srslte_tpu/ops/fec/
// viterbi_pallas.py:146) decodes, with the warp code of csrc/viterbi37.cu
// (viterbi37_warp.cuh), so its decisions are bit-identical to the plain
// twin viterbi_decode_plain. The rest replaces no Pallas kernel: the JAX
// package's PCFICH, PDCCH LLRs, rate de-matching and CRC check are plain
// jnp that XLA fuses. In eager PyTorch they are ~130 launches a receiver
// call whatever the batch (the combining, demapping and descrambling, a
// stack, pad, sum and scatter per aggregation level, the CRC as a
// matmul), and the Python that makes them; here they are two launches.
// Each computes what its plain twin computes (models/pcfich.py
// _pcfich_decode_plain, models/pdcch.py _pdcch_extract_llr_plain and
// _pdcch_blind_bits_plain), in float32 without contraction (--fmad=false).
//
// What bounds them. Kernel A reads symbol 0..CFI-1's control REs of rx 0's
// grid and of two ports' channel, once, and writes the LLRs once: at
// 100 PRB, CFI 1, 2 ports, about 34 KB a subframe, 8.7 MB for 256
// subframes, 0.003 ms at 3.35 TB/s; a few operations per RE: bytes-bound,
// and at the receiver's sizes a launch's latency. Kernel B is the Viterbi
// work of the kernel table's row 2 (per candidate 2 halo + K steps of 64
// add-compare-selects, operation- and latency-bound: 0.013 ms for K 55 and
// K 44 over 4,608 words), plus the de-rate-matching gather (the LLRs,
// read once) and a CRC of K bits a candidate.
//
// Design, kernel A: one block per subframe. Warp 0 gathers the PCFICH's
// 16 REs through its index table, combines them (MRC for 1 port, SFBC
// for 2, SFBC-FSTD for 4), demaps QPSK, descrambles with the precomputed
// signs, correlates against the 3 codewords and keeps the first maximum.
// All threads then take the PDCCH region's REs in quadruplet order, one
// RE pair a thread (the SFBC pair; on 4 ports the SFBC-FSTD pair, ports 0
// and 2 for a quadruplet's first pair, 1 and 3 for its second; MRC on
// port 0 for a 1-port channel),
// weight each LLR by the pair's CSI, descramble, and store the pair's 4
// LLRs as one 16-byte store. Nothing else is read or written.
//
// Design, kernel B: one block per subframe, one warp per (candidate, DCI
// size) job, several jobs a warp when a subframe has more than
// MAX_BLIND_WARPS. A warp de-rate-matches its candidate's L*72 LLRs
// straight into the trellis' branch-metric combinations in shared
// memory: position p of the [3, K] trellis input is the sum of the
// repetitions i, i + 3K, i + 6K, ... (i the circular-buffer position of
// p, the per-K inverse table) below E, added in ascending order from 0.
// rm_conv_rx's torch.sum adds in the same order up to 4 repetitions, and
// beyond that in all but PyTorch's CPU tail columns, where its 4-way
// split may round differently (PERF.md, section 6). Then the
// three-segment Viterbi of viterbi37_warp.cuh, lane 0's traceback into
// packed words, and the CRC16 over the K decoded bits as the XOR of each
// set bit's syndrome (a row of CRC16's parity matrix) against the
// syndrome of the RNTI mask: the plain check of dci_crc_ok, bit for bit.
// It writes the bits, the pass flags and each subframe's pass count (a
// shared counter, stored after a block barrier). The
// tables (candidates, per size its K, halo, inverse circle, syndromes and
// mask syndrome) are built once per plan in ops and uploaded once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi37_warp.cuh"

#define CTRL_THREADS 256
#define MAX_BLIND_WARPS 32  // models/pdcch.py MAX_BLIND_WARPS
#define MAX_SIZES 4         // DCI sizes a launch searches
#define MAX_K 128           // K = DCI size + 16
#define PCFICH_RES 16
// the size table's header: per size K, halo, its inverse circle's offset
// (the syndromes follow it), the RNTI mask's syndrome
#define SIZE_HDR 4

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float abs2(float2 a) {
  return a.x * a.x + a.y * a.y;
}

// SFBC (Alamouti in frequency) on the pair (ye, yo) with the pair's
// even-RE channels h0, h1 (ops/equalizer.py eq_sfbc): -> x0 or x1 (odd),
// and the clamped CSI |h0|^2 + |h1|^2
__device__ __forceinline__ float2 sfbc(float2 ye, float2 yo, float2 h0,
                                       float2 h1, bool odd, float* csi) {
  const float scale = 1.41421353816986083984375f;  // float32(sqrt(2))
  float2 x;
  if (!odd) {
    const float2 a = cmul(conj2(h0), ye), b = cmul(h1, conj2(yo));
    x = make_float2(a.x + b.x, a.y + b.y);
  } else {
    const float2 a = cmul(conj2(h0), yo), b = cmul(h1, conj2(ye));
    x = make_float2(a.x - b.x, a.y - b.y);
  }
  const float hh = fmaxf(abs2(h0) + abs2(h1), 1e-20f);
  *csi = hh;
  return make_float2(x.x / hh * scale, x.y / hh * scale);
}

// MRC on one port (models/pcfich.py, models/pdcch.py): y conj(h) over
// max(|h|^2 + noise, 1e-12)
__device__ __forceinline__ float2 mrc(float2 y, float2 h, float noise) {
  const float2 x = cmul(y, conj2(h));
  const float d = fmaxf(abs2(h) + noise, 1e-12f);
  return make_float2(x.x / d, x.y / d);
}

struct CtrlArgs {
  const float2* grid;  // rx 0's grid: subframe n at grid + n g_stride, [S K]
  long long g_stride;
  const float2* h;  // port p of subframe n at h + n h_stride + p h_pstride
  long long h_stride, h_pstride;
  int ports;
  const float* noise;  // noise[n * noise_step], or noise_val when NULL
  int noise_step;
  float noise_val;
  const int* pcf_re;     // [16] flat REs of the PCFICH
  const float* pcf_sgn;  // [32] descrambling signs, then [3][32] codewords'
  long long* cfi;        // [N]
  float* corr;           // [N] the normalized correlation
  const int* pd_re;      // [n_re] flat REs of the PDCCH region
  const float* pd_sgn;   // [2 n_re] descrambling signs
  int n_re;
  float* llr;  // [N, 2 n_re] (NULL: no PDCCH)
};

__global__ void __launch_bounds__(CTRL_THREADS) ctrl_llr_kernel(
    const CtrlArgs a) {
  __shared__ float s_llr[2 * PCFICH_RES];
  const int n = blockIdx.x;
  const float2* g = a.grid + n * a.g_stride;
  const float2* h0 = a.h + n * a.h_stride;
  const float2* h1 = h0 + a.h_pstride;
  const float noise = a.noise ? a.noise[n * a.noise_step] : a.noise_val;

  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    if (i < PCFICH_RES) {
      const int k = a.pcf_re[i];
      float2 x;
      float csi;
      if (a.ports == 1) {
        x = mrc(g[k], h0[k], noise);
      } else {
        // SFBC on ports 0-1 over RE pairs; SFBC-FSTD on 4 ports: pairs
        // (0, 1) of each quad on ports 0 and 2, pairs (2, 3) on 1 and 3
        const int e = i & ~1;
        const int ke = a.pcf_re[e], ko = a.pcf_re[e + 1];
        int pa = 0, pb = 1;
        if (a.ports == 4) {
          pa = (i & 2) ? 1 : 0;
          pb = pa + 2;
        }
        const float2* ha = h0 + pa * a.h_pstride;
        const float2* hb = h0 + pb * a.h_pstride;
        x = sfbc(g[ke], g[ko], ha[ke], hb[ke], i & 1, &csi);
      }
      s_llr[2 * i] = x.x * a.pcf_sgn[2 * i];
      s_llr[2 * i + 1] = x.y * a.pcf_sgn[2 * i + 1];
    }
    __syncwarp();
    if (i == 0) {
      float best = 0.0f, mag = 0.0f;
      int arg = 0;
      for (int c = 0; c < 3; ++c) {
        const float* cw = a.pcf_sgn + 2 * PCFICH_RES * (c + 1);
        float s = 0.0f;
        for (int j = 0; j < 2 * PCFICH_RES; ++j) s += s_llr[j] * cw[j];
        if (c == 0 || s > best) {
          best = s;
          arg = c;
        }
      }
      for (int j = 0; j < 2 * PCFICH_RES; ++j) mag += fabsf(s_llr[j]);
      a.cfi[n] = arg + 1;
      a.corr[n] = best / mag;
    }
  }

  if (a.llr == nullptr) return;
  float4* out = reinterpret_cast<float4*>(a.llr + (size_t)n * 2 * a.n_re);
  const float4* sgn = reinterpret_cast<const float4*>(a.pd_sgn);
  for (int q = threadIdx.x; 2 * q < a.n_re; q += CTRL_THREADS) {
    const int ke = a.pd_re[2 * q], ko = a.pd_re[2 * q + 1];
    const float2 ye = g[ke], yo = g[ko];
    float4 v;
    if (a.ports >= 2) {
      // SFBC on ports 0-1; SFBC-FSTD on 4 ports (36.211 6.8.4): the
      // quadruplet's first pair on ports 0 and 2, its second on 1 and 3
      const float2* ha = h0;
      const float2* hb = h1;
      if (a.ports == 4) {
        ha = h0 + (q & 1) * a.h_pstride;
        hb = ha + 2 * a.h_pstride;
      }
      float csi;
      const float2 x0 = sfbc(ye, yo, ha[ke], hb[ke], false, &csi);
      const float2 x1 = sfbc(ye, yo, ha[ke], hb[ke], true, &csi);
      v = make_float4(x0.x * csi, x0.y * csi, x1.x * csi, x1.y * csi);
    } else {
      const float2 he = h0[ke], ho = h0[ko];
      const float2 x0 = mrc(ye, he, noise), x1 = mrc(yo, ho, noise);
      const float we = abs2(he), wo = abs2(ho);
      v = make_float4(x0.x * we, x0.y * we, x1.x * wo, x1.y * wo);
    }
    const float4 s = sgn[q];
    out[q] = make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
  }
}

struct BlindArgs {
  const float* llr;  // subframe n's LLRs at llr + n llr_stride
  long long llr_stride;
  int N;
  const int* cands;  // [n_cand][2]: first LLR (cce * 72), E (L * 72)
  int n_cand;
  const int* tab;  // the size table (SIZE_HDR ints a size, then the rest)
  int n_sizes;
  int warp_bytes;
  signed char* bits;  // size s's [N, n_cand, K_s] after the smaller s'
  unsigned char* ok;  // [n_sizes, N, n_cand]
  long long* hits;    // [N] passes over every candidate and size
};

static size_t blind_warp_bytes(int K, int halo) {
  // metrics, combinations, decision words, the winner's packed words;
  // rounded to 16 bytes so that the next warp's combinations are aligned
  const size_t b = 2 * NSTATES * sizeof(float) + (size_t)K * 8 * sizeof(float) +
                   (size_t)(K + halo) * sizeof(uint2) + 4 * sizeof(int);
  return (b + 15) & ~(size_t)15;
}

__global__ void __launch_bounds__(32 * MAX_BLIND_WARPS) pdcch_blind_kernel(
    const BlindArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int block_hits;
  const int warps = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x;
  if (threadIdx.x == 0) block_hits = 0;
  __syncthreads();

  unsigned char* base = smem + (size_t)wid * a.warp_bytes;
  float* met = reinterpret_cast<float*>(base);
  float* combs = met + 2 * NSTATES;
  const float* llr = a.llr + n * a.llr_stride;
  const int ps0 = lane << 1;
  const int i0 = out_idx(ps0, 0), i1 = out_idx(ps0 | 1, 0);
  int warp_hits = 0;

  for (int j = wid; j < a.n_sizes * a.n_cand; j += warps) {
    const int si = j / a.n_cand, c = j - si * a.n_cand;
    const int* hdr = a.tab + SIZE_HDR * si;
    const int K = hdr[0], halo = hdr[1];
    const int* inv = a.tab + hdr[2];
    const int* syn = inv + 3 * K;
    // this size's bits follow the smaller sizes' [N, n_cand, K_s]
    long long bits_off = 0;
    for (int s = 0; s < si; ++s) bits_off += a.tab[SIZE_HDR * s];
    bits_off = bits_off * a.N * a.n_cand + ((long long)n * a.n_cand + c) * K;
    uint2* dec = reinterpret_cast<uint2*>(combs + 8 * K);
    int* words = reinterpret_cast<int*>(dec + K + halo);
    const float* seg = llr + a.cands[2 * c];
    const int e = a.cands[2 * c + 1], period = 3 * K;

    // de-rate-matching into the combinations: each position's repetitions
    // below E, in ascending order from 0
    for (int col = lane; col < K; col += 32) {
      float l[3];
#pragma unroll
      for (int st = 0; st < 3; ++st) {
        float acc = 0.0f;
        for (int p = inv[st * K + col]; p < e; p += period) acc += seg[p];
        l[st] = acc;
      }
      vit_combs(combs + (size_t)col * 8, l[0], l[1], l[2]);
    }
    met[lane] = 0.0f;
    met[lane + 32] = 0.0f;
    __syncwarp();

    float* cur = met;
    float* nxt = met + NSTATES;
    Acs r = {false, false, 0.0f, 0.0f};
    r = run_steps<false>(cur, nxt, combs + (size_t)(K - halo) * 8, halo,
                         nullptr, lane, i0, i1, r);
    r = run_steps<true>(cur, nxt, combs, K, dec, lane, i0, i1, r);
    r = run_steps<true>(cur, nxt, combs, halo, dec + K, lane, i0, i1, r);
    const int bs = vit_winner(r, lane);
    if (lane == 0) vit_traceback(dec, K, K + halo, bs, words);
    __syncwarp();

    // decoded bit t is packed bit K-1-t; the CRC is the XOR of the set
    // bits' syndromes, checked against the RNTI mask's
    int crc = 0;
    for (int t = lane; t < K; t += 32) {
      const int p = K - 1 - t;
      const int bit = (words[p >> 5] >> (p & 31)) & 1;
      a.bits[bits_off + t] = (signed char)bit;
      crc ^= bit ? syn[t] : 0;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) crc ^= __shfl_xor_sync(FULL, crc, off);
    const int pass = crc == hdr[3];
    if (lane == 0)
      a.ok[((long long)si * a.N + n) * a.n_cand + c] = (unsigned char)pass;
    warp_hits += pass;
    __syncwarp();  // the next job reuses the warp's shared memory
  }
  if (lane == 0 && warp_hits) atomicAdd(&block_hits, warp_hits);
  __syncthreads();
  if (threadIdx.x == 0) a.hits[n] = block_hits;
}

// Kernel A over N subframes (see CtrlArgs): the PCFICH always, the PDCCH
// region's LLRs when llr is not NULL; ports 1, 2 or 4. Returns the
// launch's CUDA error.
extern "C" int ctrl_llr_launch(const void* grid, long long g_stride,
                               const void* h, long long h_stride,
                               long long h_pstride, int ports,
                               const float* noise, int noise_step,
                               float noise_val, const int* pcf_re,
                               const float* pcf_sgn, long long* cfi,
                               float* corr, const int* pd_re,
                               const float* pd_sgn, int n_re, float* llr,
                               int N, void* stream) {
  if (N < 1 || (ports != 1 && ports != 2 && ports != 4) ||
      cfi == nullptr || corr == nullptr ||
      (llr != nullptr && (n_re < 4 || (n_re & 3))) ||
      noise_step < 0)
    return (int)cudaErrorInvalidValue;
  CtrlArgs a = {(const float2*)grid, g_stride, (const float2*)h, h_stride,
                h_pstride, ports, noise, noise_step, noise_val, pcf_re,
                pcf_sgn, cfi, corr, pd_re, pd_sgn, n_re, llr};
  ctrl_llr_kernel<<<N, CTRL_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel B over N subframes (see BlindArgs): ks [n_sizes] the sizes' K
// (the table's header holds the same), halo min(train, K); warps and
// smem must be the plan's (models/pdcch.py blind_plan). Returns the
// launch's CUDA error.
extern "C" int pdcch_blind_launch(const float* llr, long long llr_stride,
                                  int N, const int* cands, int n_cand,
                                  const int* tab, const int* ks, int n_sizes,
                                  int train, signed char* bits,
                                  unsigned char* ok, long long* hits,
                                  int warps, int smem, void* stream) {
  if (N < 1 || n_cand < 1 || n_sizes < 1 || n_sizes > MAX_SIZES ||
      train < 0 || warps < 1 || warps > MAX_BLIND_WARPS ||
      bits == nullptr || ok == nullptr || hits == nullptr)
    return (int)cudaErrorInvalidValue;
  size_t wb = 0;
  for (int s = 0; s < n_sizes; ++s) {
    const int K = ks[s];
    if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
    const size_t b = blind_warp_bytes(K, K < train ? K : train);
    wb = b > wb ? b : wb;
  }
  if ((size_t)smem != (size_t)warps * wb) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pdcch_blind_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  BlindArgs a = {llr, llr_stride, N, cands, n_cand, tab,
                 n_sizes, (int)wb, bits, ok, hits};
  pdcch_blind_kernel<<<N, 32 * warps, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
