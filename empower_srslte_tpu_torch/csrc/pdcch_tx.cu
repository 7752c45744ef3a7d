// The PDCCH transmitter, sm_90a: every DCI of a call from its payload bits
// to its REs on the antenna ports, in one launch (pdcch_tx_kernel).
//
// What it replaces. No TPU kernel: the JAX package's PDCCH encoder is
// plain jnp (empower_srslte_tpu/ops/fec/convcoder.py conv_encode, a
// lax.scan over the trellis), which XLA compiles once. In eager PyTorch the
// same chain was the plain twin models/pdcch.py _pdcch_encode_plain: a
// bit-at-a-time trellis walk that, on an unbatched DCI, indexed its tables
// with 0-d tensors and so read the card back 4 times a bit, and some 30
// launches a DCI around it (the CRC and RNTI mask, the initial state, the
// rate-matching gather, two pageable copies, the scrambling, QPSK,
// precoding, a zero grid and an add). This kernel computes what the twin
// computes, bit for bit, and adds it onto the grid in place.
//
// What bounds it. Nothing on this card: a DCI is at most 112 + 16 bits
// coded to L*72 <= 576 bits, 288 REs a port. The bytes are a few KB a
// launch, so a launch costs its latency (a few microseconds); the design
// keeps every step parallel and short and reads nothing back to the host.
//
// Design: one block per (grid row, DCI), up to MAX_DCIS DCIs a launch (the
// wrapper loops above that). A DCI's size and circle table are launch
// arguments, its RNTI, first CCE and level are read from the card (a
// table the wrapper copies in every call), so a CUDA graph that captured
// a launch serves any DCIs of those sizes. In the block, in TS order:
//  1. the payload's bits into shared memory, and the CRC16 of 36.212
//     5.1.1 (a zero register, no inversion) by one thread's bit-serial
//     register, XORed with the RNTI's 16 bits, MSB first (5.3.3.2);
//  2. the tail-biting rate-1/3 code of 5.1.3.1 in its parity form: the
//     code is linear and circular, so d_j(i) is the parity of generator
//     g_j (133, 171, 165 octal, the MSB on the newest bit) over the 7
//     inputs u((i - t) mod K), t = 0..6; no trellis walk;
//  3. the rate matching of 5.1.4.2: the E output bits read cyclically
//     one circle of the circular buffer (the three sub-block
//     interleavers' reads, NULLs skipped), as ops/fec/rm_conv.py's table
//     ("rmc_circle", K) has it: each place's flat index into d[3, K];
//  4. the scrambling of 36.211 6.8.2 at offset cce*72, read as the signs
//     1 - 2c(n) of the region's sequence (the receive kernel's table);
//  5. QPSK (6.3.2) with the float32 1/sqrt(2) of ops/modem.py modulate;
//  6. transmit diversity as ops/equalizer.py precode_diversity does it:
//     the symbols as they are on 1 port, SFBC on 2 (pair (x0, x1) as x0 s,
//     x1 s on port 0 and -x1* s, x0* s on port 1), SFBC-FSTD on 4 (a
//     quadruplet's first pair on ports 0 and 2, its second on 1 and 3);
//  7. each port's value added onto the grid's RE idx[cce*36 + n] of that
//     port (the region's flat RE indices in quadruplet order). REs of
//     another DCI, of the PCFICH, PHICH and CRS are never these REs, so
//     the blocks write disjoint REs and the add is the twin's.
// A thread takes a quadruplet: 8 coded bits, 4 symbols, their ports. Every
// product and sum is one rounded float32 operation (--fmad=false), as the
// twin's are on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define MAX_DCIS 8   // models/pdcch.py MAX_TX_DCIS
#define MAX_K 128    // K = DCI size + 16, as the blind kernel's
#define BITS_PER_CCE 72
#define RE_PER_CCE 36

// generators G0 = 133, G1 = 171, G2 = 165 (octal): bit 6 - t on u(i - t)
__constant__ unsigned char POLY[3] = {0133, 0171, 0165};

struct TxArgs {
  float2* grid;            // [rows, ports, plane] complex64
  long long row_stride;    // complex elements between rows of the grid
  long long port_stride;   // complex elements between ports
  int ports;               // 1, 2 or 4
  const int* re;           // the region's flat RE indices, quadruplet order
  const float* sgn;        // 1 - 2c(n) over the region's 2 n_re bits
  int n_re;
  const signed char* bits[MAX_DCIS];  // each DCI's payload bits, 0/1
  long long bits_stride[MAX_DCIS];    // between rows (0: one for all rows)
  int size[MAX_DCIS];                 // payload bits
  const long long* circle[MAX_DCIS];  // rm_conv's circle of K = size + 16
  const int* place;  // [DCIs][3] on the card: RNTI, first CCE, level L
};

__device__ __forceinline__ float2 scaled(float x, float y, float s) {
  return make_float2(__fmul_rn(x, s), __fmul_rn(y, s));
}

__device__ __forceinline__ void add_re(float2* p, float2 v) {
  float2 g = *p;
  *p = make_float2(__fadd_rn(g.x, v.x), __fadd_rn(g.y, v.y));
}

__global__ void __launch_bounds__(THREADS)
pdcch_tx_kernel(const TxArgs a) {
  __shared__ unsigned char u[MAX_K];
  const int row = blockIdx.x, dci = blockIdx.y, tid = threadIdx.x;
  const int size = a.size[dci], K = size + 16;
  const int rnti = a.place[3 * dci], first = a.place[3 * dci + 1],
            L = a.place[3 * dci + 2];
  // the wrapper checked the place it copied in; a wrong one writes nothing
  if ((L != 1 && L != 2 && L != 4 && L != 8) || first < 0 ||
      (first + L) * RE_PER_CCE > a.n_re)
    return;
  const signed char* bits = a.bits[dci] + row * a.bits_stride[dci];

  // 1. payload, CRC16, RNTI mask
  for (int i = tid; i < size; i += THREADS) u[i] = (unsigned char)bits[i];
  __syncthreads();
  if (tid == 0) {
    unsigned reg = 0;
    for (int i = 0; i < size + 16; ++i) {
      reg = (reg << 1) | (i < size ? u[i] : 0u);
      if (reg & 0x10000u) reg ^= 0x11021u;
    }
    const unsigned crc = (reg ^ (unsigned)rnti) & 0xffffu;
    for (int j = 0; j < 16; ++j) u[size + j] = (crc >> (15 - j)) & 1u;
  }
  __syncthreads();

  // 2, 4-7: a quadruplet a thread
  const long long* circle = a.circle[dci];
  const int n3 = 3 * K, quads = L * (RE_PER_CCE / 4);
  const float S = 0.70710677f;  // float32(1 / sqrt(2))
  float2* out = a.grid + row * a.row_stride;
  const int* re = a.re + first * RE_PER_CCE;
  const float* sgn = a.sgn + first * BITS_PER_CCE;
  for (int q = tid; q < quads; q += THREADS) {
    float2 sym[4];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int e = 8 * q + b;
      const int f = (int)circle[e % n3];
      const int j = f / K, i = f - j * K;
      const unsigned g = POLY[j];
      unsigned d = 0;
#pragma unroll
      for (int t = 0; t < 7; ++t) {
        const int at = i - t < 0 ? i - t + K : i - t;
        d ^= (g >> (6 - t)) & u[at];
      }
      // 1 - 2 (d ^ c), the scrambled bit's sign, times 1/sqrt(2)
      const float v = (sgn[e] < 0.0f) != (d != 0) ? -S : S;
      if (b & 1) sym[b >> 1].y = v; else sym[b >> 1].x = v;
    }
    const int* idx = re + 4 * q;
    if (a.ports == 1) {
#pragma unroll
      for (int n = 0; n < 4; ++n) add_re(out + idx[n], sym[n]);
    } else if (a.ports == 2) {
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        const float2 x0 = sym[n], x1 = sym[n + 1];
        add_re(out + idx[n], scaled(x0.x, x0.y, S));
        add_re(out + idx[n + 1], scaled(x1.x, x1.y, S));
        add_re(out + a.port_stride + idx[n], scaled(-x1.x, x1.y, S));
        add_re(out + a.port_stride + idx[n + 1], scaled(x0.x, -x0.y, S));
      }
    } else {
      // SFBC-FSTD: (x0, x1) on ports 0 and 2 over REs 0, 1 of the
      // quadruplet, (x2, x3) on ports 1 and 3 over REs 2, 3
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x0 = sym[2 * h], x1 = sym[2 * h + 1];
        float2* p = out + h * a.port_stride;
        float2* p2 = out + (2 + h) * a.port_stride;
        add_re(p + idx[2 * h], scaled(x0.x, x0.y, S));
        add_re(p + idx[2 * h + 1], scaled(x1.x, x1.y, S));
        add_re(p2 + idx[2 * h], scaled(-x1.x, x1.y, S));
        add_re(p2 + idx[2 * h + 1], scaled(x0.x, -x0.y, S));
      }
    }
  }
}

// One launch over ``rows`` grid rows and ``n_dci`` DCIs (see TxArgs): the
// host arrays bits [n_dci] (device pointers), bits_stride [n_dci], size
// [n_dci] and circle [n_dci] (device pointers), and place, the card's
// [n_dci][3]. Returns the launch's CUDA error; refuses what the kernel
// does not take of what the host sees.
extern "C" int pdcch_tx_launch(void* grid, long long row_stride,
                               long long port_stride, int ports, int rows,
                               const int* re, const float* sgn, int n_re,
                               int n_dci, const void* const* bits,
                               const long long* bits_stride, const int* size,
                               const void* const* circle, const int* place,
                               void* stream) {
  if (grid == nullptr || re == nullptr || sgn == nullptr ||
      place == nullptr || rows < 1 || n_dci < 1 || n_dci > MAX_DCIS ||
      (ports != 1 && ports != 2 && ports != 4) || port_stride < 0 ||
      row_stride < 0)
    return (int)cudaErrorInvalidValue;
  TxArgs a = {(float2*)grid, row_stride, port_stride, ports, re, sgn, n_re};
  for (int d = 0; d < n_dci; ++d) {
    if (bits[d] == nullptr || circle[d] == nullptr || bits_stride[d] < 0 ||
        size[d] < 1 || size[d] + 16 > MAX_K)
      return (int)cudaErrorInvalidValue;
    a.bits[d] = (const signed char*)bits[d];
    a.bits_stride[d] = bits_stride[d];
    a.size[d] = size[d];
    a.circle[d] = (const long long*)circle[d];
  }
  a.place = place;
  pdcch_tx_kernel<<<dim3((unsigned)rows, (unsigned)n_dci), THREADS, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
