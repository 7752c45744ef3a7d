// LTE turbo encoder, 36.212 5.1.3.2: the rate-1/3 PCCC of two 8-state
// RSC constituents, sm_90a.
//
// Replaces no TPU kernel: the JAX package's encoder is plain jnp
// (empower_srslte_tpu/ops/fec/turbo_encoder.py turbo_encode_fast and
// turbo_encode_mm), which XLA compiles into a few fused passes. In eager
// PyTorch the same walk was a byte-a-step Python loop: K/8 steps of five
// launches over every code block and both constituents, with the QPP
// gather, the packing, the unpacking, the tail lookups and the stacks
// around it, some 3,650 launches a call at the eNB transmitter's batch.
// This kernel does all of it in one launch for every code block of one
// size K, and computes what the plain twin (ops/fec/turbo_encoder.py
// _turbo_encode_plain) computes, bit for bit: d [rows, 3, K+4] int8, the
// systematic stream, both parity streams and the trellis terminations
// with the tail permutation of 36.212 5.1.3.2.2.
//
// What bounds it. Bytes: the code blocks' bits read once as int8 and d
// written once as int8, 7K + 12 bytes a code block; at the 20 MHz 2x2 TM4
// transmitter's batch (2 codewords x 256 subframes x 13 code blocks of
// K 5824) 155 MB, 0.046 ms at 3.35 TB/s. The trellis is no bound once it
// is taken a word at a time (below).
//
// Design. The constituent's feedback register a_n = u_n ^ a_{n-2} ^
// a_{n-3} (g0 = 1 + D^2 + D^3) is u / g0 over GF(2), and since g0 divides
// 1 + D^7, 1 / g0 = (1 + D^2 + D^3 + D^4) / (1 + D^7): with b_n = u_n ^
// u_{n-2} ^ u_{n-3} ^ u_{n-4}, a_n is the XOR of b_m over every m <= n of
// n's class mod 7. So a 32-bit word of a is a word of b, its prefix XOR
// at stride 7 (three shifts), and the carry from the words before it: the
// XOR of their b per class mod 7, 7 bits. That carry is an XOR scan, so
// the serial chain of K steps becomes a short scan: each lane of a warp
// takes a run of at most 6 consecutive words of one constituent, folds
// its words' b into a 7-bit class vector, a 5-step shuffle scan gives
// every lane the classes of the words before its run, and each lane then
// finishes its words: a, the parity z_n = a_n ^ a_{n-1} ^ a_{n-3} (g1 =
// 1 + D + D^3, the previous word's last a read from the same classes),
// and at the last word the final state, whose three tail steps are
// closed forms. One block of four warps takes two code blocks: it stages
// their bytes in shared memory with 8-byte loads; each thread packs words
// of the natural input from 32 staged bytes (a multiply gathers eight
// bytes' low bits); the four warps pack the interleaved input with
// ballots, each a quarter of the words of both code blocks, lane j of
// word w reading byte pi(32w + j) of each staged block (pi stepped from
// f1 and f2 of Table 5.1.3-3 with adds and compares alone, once for both
// blocks); one warp a code block and constituent scans and finishes it;
// and all four warps write the six streams of d, each lane four bytes (a
// nibble spread to bytes) a store, so that a warp writes 128 consecutive
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define ROWS 2                // code blocks a block: a warp a constituent
#define KMAX 6144
#define NWMAX (KMAX / 32)     // 32-bit words of one constituent's input
#define SEG (NWMAX / 32)      // words a lane takes, at most
#define FULL 0xffffffffu
static_assert(THREADS == 32 * 2 * ROWS && ROWS == 2,
              "one warp a code block and constituent");

struct Stage {
  uint8_t u[ROWS * KMAX + 32];       // the code blocks' bytes, K apart
  unsigned in[ROWS][2][NWMAX];       // each constituent's input, packed
  unsigned par[ROWS][2][NWMAX];      // each constituent's parity, packed
  unsigned char state[ROWS][2];      // the final states (r1 r2 r3)
};

// a 7-bit class vector p (bit c: class c) seen from a word that starts in
// class o: bit r is p's class (o + r) mod 7
__device__ __forceinline__ unsigned rotr7(unsigned p, int o) {
  return ((p >> o) | (p << (7 - o))) & 0x7f;
}

__device__ __forceinline__ unsigned rotl7(unsigned p, int o) {
  return ((p << o) | (p >> (7 - o))) & 0x7f;
}

// the XOR of a word's bits per position mod 7
__device__ __forceinline__ unsigned fold7(unsigned b) {
  return (b ^ (b >> 7) ^ (b >> 14) ^ (b >> 21) ^ (b >> 28)) & 0x7f;
}

// a word whose bit j is bit j mod 7 of r
__device__ __forceinline__ unsigned spread7(unsigned r) {
  return r * 0x10204081u;
}

// the tail bits of the termination from the final state s = r1 r2 r3:
// the three inputs x_K.. and parities z_K.. as bits 0-2
__device__ __forceinline__ unsigned tail_x(unsigned s) {
  const unsigned r1 = s >> 2 & 1, r2 = s >> 1 & 1, r3 = s & 1;
  return (r2 ^ r3) | (r1 ^ r2) << 1 | r1 << 2;
}

__device__ __forceinline__ unsigned tail_z(unsigned s) {
  const unsigned r1 = s >> 2 & 1, r2 = s >> 1 & 1, r3 = s & 1;
  return (r1 ^ r3) | r2 << 1 | r1 << 2;
}

// d_stream[K..K+3] as the four bits of a nibble, 36.212 5.1.3.2.2:
// d0 x_K z_K+1 x'_K z'_K+1; d1 z_K x_K+2 z'_K x'_K+2;
// d2 x_K+1 z_K+2 x'_K+1 z'_K+2
__device__ __forceinline__ unsigned tail_nibble(int stream, unsigned s1,
                                                unsigned s2) {
  // bits 0 and 2 from the first of the pair at step i, bits 1 and 3
  // from the second at step j; d1 takes z first, d0 and d2 x
  const bool zx = stream == 1;
  const int i = stream == 2, j = stream == 0 ? 1 : 2;
  const unsigned first1 = zx ? tail_z(s1) : tail_x(s1);
  const unsigned second1 = zx ? tail_x(s1) : tail_z(s1);
  const unsigned first2 = zx ? tail_z(s2) : tail_x(s2);
  const unsigned second2 = zx ? tail_x(s2) : tail_z(s2);
  return (first1 >> i & 1) | (second1 >> j & 1) << 1 |
         (first2 >> i & 1) << 2 | (second2 >> j & 1) << 3;
}

// bit j of the result is bit 0 of byte j of x
__device__ __forceinline__ unsigned bits8(unsigned long long x) {
  return (unsigned)(((x & 0x0101010101010101ull) * 0x0102040810204080ull) >>
                    56);
}

// one constituent's parity words and final state from its packed input,
// by one warp
__device__ void rsc(const unsigned* in, unsigned* par, unsigned char* state,
                    int k, int nw, int lane) {
  const int seg = (nw + 31) / 32;
  const int w0 = lane * seg;
  unsigned x[SEG], q[SEG];
  unsigned mine = 0;               // the classes of the lane's run's b
#pragma unroll
  for (int j = 0; j < SEG; ++j) {
    const int w = w0 + j;
    x[j] = q[j] = 0;
    if (j < seg && w < nw) {
      const unsigned u = in[w], up = w ? in[w - 1] : 0u;
      const unsigned b = u ^ (u << 2 | up >> 30) ^ (u << 3 | up >> 29) ^
                         (u << 4 | up >> 28);
      unsigned a = b ^ b << 7;
      a ^= a << 14;
      a ^= a << 28;
      x[j] = a;
      q[j] = rotl7(fold7(b), 4 * w % 7);     // 32 w = 4 w mod 7
      mine ^= q[j];
    }
  }
  unsigned before = mine;          // inclusive XOR scan over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(FULL, before, o);
    if (lane >= o) before ^= v;
  }
  before ^= mine;                  // the classes of every earlier word
#pragma unroll
  for (int j = 0; j < SEG; ++j) {
    const int w = w0 + j;
    if (j < seg && w < nw) {
      const unsigned r = rotr7(before, 4 * w % 7);
      const unsigned a = x[j] ^ spread7(r);
      // the previous word's a_{32w-1} (class 6 from here) and
      // a_{32w-3..32w-1} (classes 4-6)
      par[w] = a ^ (a << 1 | (r >> 6 & 1)) ^ (a << 3 | (r >> 4 & 7));
      if (w == nw - 1) {
        const int j1 = k - 1 - 32 * w;       // bit of a_{K-1}, at least 7
        *state = (a >> j1 & 1) << 2 | (a >> (j1 - 1) & 1) << 1 |
                 (a >> (j1 - 2) & 1);
      }
      before ^= q[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
turbo_enc_kernel(const int8_t* __restrict__ u, int8_t* __restrict__ d,
                 int rows, int k, int f1, int f2) {
  __shared__ __align__(16) Stage s;
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = warp >> 1, c = warp & 1;
  const int nw = (k + 31) / 32;

  // the block's code blocks are consecutive rows: nr K bytes, 8-aligned
  const uint2* src = reinterpret_cast<const uint2*>(u + (long long)r0 * k);
  uint2* staged = reinterpret_cast<uint2*>(s.u);
  const int n8 = nr * k / 8;
#pragma unroll 4
  for (int i = tid; i < n8; i += THREADS) staged[i] = __ldg(src + i);
  __syncthreads();

  // the natural input packed a word a thread from 32 staged bytes (the
  // last word masked at K: past it lie the next code block or the pad)
  for (int i = tid; i < nr * nw; i += THREADS) {
    const int r = i >= nw, w = i - r * nw;
    const unsigned long long* b =
        reinterpret_cast<const unsigned long long*>(s.u + r * k + 32 * w);
    unsigned word = bits8(b[0]) | bits8(b[1]) << 8 | bits8(b[2]) << 16 |
                    bits8(b[3]) << 24;
    if (k - 32 * w < 32) word &= (1u << (k - 32 * w)) - 1;
    s.in[r][0][w] = word;
  }
  // the interleaved input: each warp a quarter of the words, both code
  // blocks with one pi, packed with ballots; lane j of word w reads byte
  // pi(32w + j), pi(i) = (f1 i + f2 i^2) mod K stepped in i by 32:
  // pi(i + 32) = pi(i) + g(i), g(i + 32) = g(i) + 2048 f2, both mod K
  {
    const int per = (nw + 3) / 4, w0 = warp * per;
    const int w1 = min(nw, w0 + per), i0 = 32 * w0 + lane;
    int pi = (f2 * i0 + f1) % k * i0 % k;
    int g = (32 * f1 + 1024 * f2 + 64 * f2 * i0) % k;
    const int step = 2048 * f2 % k;
#pragma unroll 4
    for (int w = w0; w < w1; ++w) {
      const bool in_k = 32 * w + lane < k;
      const unsigned a = __ballot_sync(FULL, in_k && (s.u[pi] & 1));
      const unsigned b =
          __ballot_sync(FULL, in_k && nr > 1 && (s.u[k + pi] & 1));
      if (lane == (w & 31)) {
        s.in[0][1][w] = a;
        s.in[1][1][w] = b;
      }
      pi += g;
      pi -= pi >= k ? k : 0;
      g += step;
      g -= g >= k ? k : 0;
    }
  }
  __syncthreads();

  if (row < nr)
    rsc(s.in[row][c], s.par[row][c], &s.state[row][c], k, nw, lane);
  __syncthreads();

  // d: the block's 3 nr streams of K + 4 bytes are consecutive
  const int n4 = (k + 4) / 4;
  unsigned* out =
      reinterpret_cast<unsigned*>(d + (long long)r0 * 3 * (k + 4));
  for (int st = 0; st < 3 * nr; ++st) {
    const int rr = st / 3, stream = st % 3;
    const unsigned* bits = stream == 0 ? s.in[rr][0] : s.par[rr][stream - 1];
    const unsigned tail =
        tail_nibble(stream, s.state[rr][0], s.state[rr][1]);
    for (int g = tid; g < n4; g += THREADS) {
      const unsigned nib =
          g < k / 4 ? bits[g >> 3] >> (4 * (g & 7)) & 0xf : tail;
      out[st * n4 + g] = nib * 0x00204081u & 0x01010101u;  // a bit a byte
    }
  }
}

// One launch for ``rows`` code blocks of size k: ``u`` [rows, k] int8 0/1
// (8-byte aligned), ``d`` [rows, 3, k + 4] int8 (4-byte aligned); f1 and
// f2 are K's QPP coefficients (36.212 Table 5.1.3-3).
extern "C" int turbo_enc_launch(const int8_t* u, int8_t* d, int rows, int k,
                                int f1, int f2, void* stream) {
  if (u == nullptr || d == nullptr || rows < 1 || k < 40 || k > KMAX ||
      k % 8 != 0 || f1 < 1 || f2 < 1 || (uintptr_t)u % 8 != 0 ||
      (uintptr_t)d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + ROWS - 1) / ROWS);
  turbo_enc_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      u, d, rows, k, f1, f2);
  return (int)cudaGetLastError();
}
