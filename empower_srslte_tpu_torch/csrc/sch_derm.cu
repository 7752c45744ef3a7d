// Turbo rate de-matching into the turbo decoder's inputs, sm_90a.
//
// Replaces no TPU kernel: the JAX package's de-rate-matching and the
// decoder's input preparation are plain jnp that XLA fuses. In eager
// PyTorch they were a chain of full-size passes per call (a stack of the
// code blocks' LLR slices, the repetition sum, a zeroed buffer, an
// index_put through the circle table, a concatenation of the (E, F)
// groups, a cast to the metric dtype, four concatenations over strided
// slices and four transposes), some 20 launches; this kernel does all of
// it in one launch for every code block of one size K. Per code block it
// computes what the plain twin (ops/fec/rate_matching.py
// _derm_to_decoder_plain: RateMatchTurbo.rx, then TurboDecoder.prepare)
// computes: the soft de-rate-matching of 36.212 5.1.4.1.2 (the circular
// buffer from k0(rv), the NULL and filler positions, the sum over
// repetitions when E exceeds the circle, the HARQ softbuffer's add, on
// the int8 lane in integers saturated to +-127), written as the new
// softbuffer [B, 3(K+4)]; and the decoder's time-major inputs in its
// metric type (bfloat16 rounded to nearest even, or float32): sys1, par1
// and par2 [K+3, B] and sys2's tail [3, B], with the tail
// de-permutation of 36.212 5.1.3.2.2, and the filler bits' prior on
// stream 0's first F positions (the decoder's inputs only, never the
// softbuffer). The repetitions add in ascending order from 0, as one
// repetition or two add in the twin's sum; more are rounded in another
// order than the twin's.
//
// What bounds it. Bytes: at the 20 MHz TM4 receiver's batch (2 codewords
// x 256 subframes x 13 code blocks of K 5824, E ~6648) the LLRs read
// once (177 MB float32), the softbuffer written once (465 MB) and the
// decoder's inputs written once (233 MB bfloat16): 0.261 ms at
// 3.35 TB/s.
//
// Design. The sub-block interleaver writes each stream row by row into
// 32 columns and reads it column by column, so 16 interleaver rows x 32
// columns of one stream (512 consecutive positions of d) come from 32
// runs of 16 consecutive circle positions, one per column. One block of
// 512 threads takes TILE_CBS code blocks (consecutive decoder columns) x
// one such tile of one stream; a stream's three blocks of a tile are
// neighbours in the grid, so the circle runs that streams 1 and 2 share
// (they interlace in the circular buffer) are read from L2 the second
// time. The block first stages the tile's inverse circles in shared
// memory (one for the code blocks without filler bits and one for those
// with), so that the LLR loads depend on nothing in global memory.
// (1) A half warp's lanes are the tile's rows: they read a run of one
// code block (a coalesced load), add its repetitions in registers and
// store it into the tile, whose rows are padded against bank conflicts;
// each half warp keeps UNROLL runs in flight. (2) A warp walks one
// interleaver row of a code block, 32 consecutive positions of d: it adds
// the softbuffer, saturates on the int8 lane, writes the new softbuffer
// contiguously and puts the prior on the filler bits. (3) A half warp
// writes one time-major row of the tile's TILE_CBS decoder columns (32
// bytes of bfloat16: one full sector) through the shared-memory
// transpose, stepping a pointer down the rows where an interleaver row
// has no dummy and no tail; the 12 tail entries of a code block go to
// their decoder rows one by one. Tuned on an NVIDIA H100 80GB HBM3 at
// 700 W at the 20 MHz TM4 batch, in turns with variants of UNROLL and
// THREADS and with a grid that put the code block tiles fastest (slower):
// 0.50 ms, 1.9x the bound above; a subframe's launch takes about 9 us,
// the latency of its few blocks' three dependent phases.
// The tables (each code block's LLR offset, E, circle length and filler
// bits; the inverse circles) come from the port's plan
// (ops/fec/rate_matching.py derm_table), so one kernel serves every K,
// E, F, rv and circular buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NCOLS 32       // sub-block interleaver columns (36.212 5.1.4.1.1)
#define TILE_CBS 16    // code blocks (decoder columns) a block
#define TILE_ROWS 16   // interleaver rows a block: a half warp's lanes
#define TILE (TILE_ROWS * NCOLS)
#define ROW_PAD (NCOLS + 1)                  // a tile row in shared memory
#define CB_PAD (TILE_ROWS * ROW_PAD + 2)     // a code block's tile
#define INV_PAD (TILE_ROWS + 1)              // a column of inverse circle
#define THREADS 512
#define WARPS (THREADS / 32)
#define UNROLL 4       // circle runs in flight a half warp
#define META 5         // a code block's LLR offset, E, n, table, F
static_assert(TILE_ROWS == 16 && TILE_CBS == 16,
              "a half warp spans the tile's rows and its code blocks");

// each stream's four tail entries (d_s[K..K+3]): the decoder array
// (0 sys1, 1 par1, 2 par2, 3 sys2's tail) and the row past K (arrays 0-2)
// or within the tail (array 3), 36.212 5.1.3.2.2
__constant__ int8_t TAIL_ARRAY[3][4] = {{0, 1, 3, 2}, {1, 0, 2, 3},
                                        {0, 1, 3, 2}};
__constant__ int8_t TAIL_ROW[3][4] = {{0, 1, 0, 1}, {0, 2, 0, 2},
                                      {1, 2, 1, 2}};

template <typename L>
struct Lane;

// float32 LLRs: the repetitions and the softbuffer add in float32
template <>
struct Lane<float> {
  using Acc = float;
  static __device__ float saturate(float v) { return v; }
  static __device__ void put(float* p, float v) { *p = v; }
};

// the int8 lane: integers (exact in float32 below 2^24), saturated to
// +-127 after the softbuffer add (rm_turbo.c's 8-bit lane)
template <>
struct Lane<int8_t> {
  using Acc = int;
  static __device__ float saturate(float v) {
    return fminf(fmaxf(v, -127.0f), 127.0f);
  }
  static __device__ void put(int8_t* p, float v) { *p = (int8_t)(int)v; }
};

__device__ __forceinline__ void put_metric(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_metric(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* llr;        // [rows, row_stride] LLRs (E of each code block
                          // from its offset)
  long long row_stride;   // elements between two rows of llr
  int cbs;                // code blocks of this K a row
  int b_total;            // decoder columns: rows x cbs, row-major
  const int* tab;         // [cbs, META] code blocks, then inverse circles
  const void* sb_in;      // [b_total, 3(K+4)] or null
  void* sb_out;           // [b_total, 3(K+4)]
  const float* prior;     // [rows] filler prior, or null: prior_const
  float prior_const;
  void* out;              // [3(K+4) + 3, b_total]: sys1 at row 0, par1 at
                          // K+4, par2 at 2(K+4), sys2's tail at 3(K+4)
  int k;
  int rows_il;            // interleaver rows R = ceil((K+4) / 32)
  int nd;                 // dummy positions 32 R - (K+4)
  int row_tiles;          // ceil(R / TILE_ROWS)
};

template <typename L, typename M>
__global__ void __launch_bounds__(THREADS)
    sch_derm_kernel(const Args a) {
  using Acc = typename Lane<L>::Acc;
  extern __shared__ float tile[];          // [TILE_CBS][CB_PAD]
  __shared__ long long base_s[TILE_CBS];   // a code block's first LLR
  __shared__ int e_s[TILE_CBS], n_s[TILE_CBS], tab_s[TILE_CBS],
      f_s[TILE_CBS], slot_s[TILE_CBS];
  __shared__ float prior_s[TILE_CBS];
  // the tile's inverse circles, column by column: code blocks without
  // and with filler bits (a launch has at most these two)
  __shared__ int inv_s[2][NCOLS * INV_PAD];
  __shared__ int slot_tab[2];

  // the streams fastest: the circle runs that streams 1 and 2 share are
  // read twice close together
  const int s = blockIdx.x % 3;
  const int rest = blockIdx.x / 3;
  const int row0 = (rest % a.row_tiles) * TILE_ROWS;
  const int b0 = (rest / a.row_tiles) * TILE_CBS;
  const int ncb = min(TILE_CBS, a.b_total - b0);
  const int nrows = min(TILE_ROWS, a.rows_il - row0);
  const int d = a.k + 4;
  const long long len = 3LL * d;
  const L* llr = (const L*)a.llr;

  if (threadIdx.x < ncb) {
    const int b = b0 + threadIdx.x;
    const int row = b / a.cbs;
    const int* m = a.tab + (b - row * a.cbs) * META;
    base_s[threadIdx.x] = row * a.row_stride + m[0];
    e_s[threadIdx.x] = m[1];
    n_s[threadIdx.x] = m[2];
    tab_s[threadIdx.x] = m[3];
    f_s[threadIdx.x] = m[4];
    prior_s[threadIdx.x] = a.prior ? a.prior[row] : a.prior_const;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    slot_tab[0] = tab_s[0];
    slot_tab[1] = -1;
    for (int cb = 1; cb < ncb; ++cb)
      if (tab_s[cb] != tab_s[0]) slot_tab[1] = tab_s[cb];
  }
  __syncthreads();
  if (threadIdx.x < ncb)
    slot_s[threadIdx.x] = tab_s[threadIdx.x] == slot_tab[0] ? 0 : 1;
  for (int q = threadIdx.x; q < 2 * TILE; q += THREADS) {
    const int slot = q / TILE, c = (q % TILE) / TILE_ROWS,
              rl = q % TILE_ROWS;
    if (slot_tab[slot] >= 0)
      inv_s[slot][c * INV_PAD + rl] =
          rl < nrows ? __ldg(a.tab + slot_tab[slot] +
                             (s * NCOLS + c) * a.rows_il + row0 + rl)
                     : -1;
  }
  __syncthreads();

  // (1) the circle runs: a half warp's lanes are the tile's rows, one
  // (code block, column) a half warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane % TILE_ROWS, half = lane / TILE_ROWS;
  const int tasks = ncb * (NCOLS / 2);
  for (int t0 = warp; t0 < tasks; t0 += WARPS * UNROLL) {
    int pos[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int task = t0 + u * WARPS;
      pos[u] = -1;
      if (task < tasks) {
        const int cb = task / (NCOLS / 2);
        const int c = task % (NCOLS / 2) + half * (NCOLS / 2);
        const int i = inv_s[slot_s[cb]][c * INV_PAD + rl];
        pos[u] = i < e_s[cb] ? i : -1;
      }
    }
    Acc v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int cb = (t0 + u * WARPS) / (NCOLS / 2);
      v[u] = 0;
      if (pos[u] >= 0) v[u] += (Acc)__ldg(llr + base_s[cb] + pos[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (pos[u] < 0) continue;
      const int cb = (t0 + u * WARPS) / (NCOLS / 2);
      const int e = e_s[cb], n = n_s[cb];
      for (int q = pos[u] + n; q < e; q += n)
        v[u] += (Acc)__ldg(llr + base_s[cb] + q);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int task = t0 + u * WARPS;
      if (task < tasks && rl < nrows)
        tile[(task / (NCOLS / 2)) * CB_PAD + rl * ROW_PAD +
             task % (NCOLS / 2) + half * (NCOLS / 2)] = (float)v[u];
    }
  }
  __syncthreads();

  // (2) the softbuffer: a warp takes an interleaver row of a code block,
  // 32 consecutive positions of d_s, a lane each
  const L* sb_in = (const L*)a.sb_in;
  L* sb_out = (L*)a.sb_out;
  for (int cb = 0; cb < ncb; ++cb) {
    const long long pb = (long long)(b0 + cb) * len + s * d - a.nd;
    const int fill = s == 0 ? f_s[cb] : 0;     // filler bits: stream 0 only
    for (int r = warp; r < nrows; r += WARPS) {
      const int y = (row0 + r) * NCOLS + lane;
      if (y < a.nd) continue;
      float* cell = tile + cb * CB_PAD + r * ROW_PAD + lane;
      float v = *cell;
      if (sb_in) v += (float)sb_in[pb + y];
      v = Lane<L>::saturate(v);
      Lane<L>::put(sb_out + pb + y, v);
      *cell = y - a.nd < fill ? prior_s[cb] : v;
    }
  }
  __syncthreads();

  // (3) the decoder's inputs, time-major: a half warp writes a row of
  // the tile's TILE_CBS decoder columns (32 bytes of bfloat16), the two
  // halves neighbouring columns of the interleaver row
  const int cbl = lane % TILE_CBS, hl = lane / TILE_CBS;
  if (cbl < ncb) {
    M* const out = (M*)a.out + b0 + cbl;
    for (int r = warp; r < nrows; r += WARPS) {
      const float* src = tile + cbl * CB_PAD + r * ROW_PAD;
      const int t0 = (row0 + r) * NCOLS - a.nd;   // the row's first t
      if (t0 >= 0 && t0 + NCOLS <= a.k) {
        // no dummy and no tail: rows s (K+4) + t of the stream's array
        M* dst = out + ((long long)s * d + t0 + hl) * a.b_total;
        const long long step = 2LL * a.b_total;
#pragma unroll 4
        for (int c = hl; c < NCOLS; c += 2, dst += step)
          put_metric(dst, src[c]);
        continue;
      }
      for (int c = hl; c < NCOLS; c += 2) {
        const int t = t0 + c;
        if (t < 0) continue;
        long long row = (long long)s * d + t;
        if (t >= a.k) {
          const int arr = TAIL_ARRAY[s][t - a.k];
          row = (long long)arr * d + (arr < 3 ? a.k : 0) +
                TAIL_ROW[s][t - a.k];
        }
        put_metric(out + row * a.b_total, src[c]);
      }
    }
  }
}

template <typename L, typename M>
int launch(const Args& a, unsigned blocks, cudaStream_t st) {
  const size_t smem = sizeof(float) * TILE_CBS * CB_PAD;
  const cudaError_t e = cudaFuncSetAttribute(
      sch_derm_kernel<L, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sch_derm_kernel<L, M><<<blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// One launch for every code block of size k of ``rows`` LLR rows:
// ``cbs`` code blocks a row, decoder column b = row * cbs + j. ``tab``:
// [cbs, 5] (LLR offset in the row, E, circle length n, offset of the
// code block's inverse circle in tab, filler bits F), then the inverse
// circles, each [3, 32, R] (stream, column, row): the circle position of
// d_s[row * 32 + column - ND], or -1 (a dummy, NULL or filler position).
// ``sb_in`` (or null) and ``sb_out`` are [rows * cbs, 3(K+4)] of the
// LLR type; ``prior`` (or null: ``prior_const``) is per row; ``out`` is
// [3(K+4) + 3, rows * cbs] of the metric type.
extern "C" int sch_derm_launch(const void* llr, int llr_int8,
                               long long row_stride, int rows, int cbs,
                               const int* tab, const void* sb_in,
                               void* sb_out, const float* prior,
                               float prior_const, void* out,
                               int metric_bf16, int k, void* stream) {
  if (llr == nullptr || tab == nullptr || sb_out == nullptr ||
      out == nullptr || rows < 1 || cbs < 1 || k < 40 || k > 6144 ||
      (long long)rows * cbs > (1LL << 30) || row_stride < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.llr = llr;
  a.row_stride = row_stride;
  a.cbs = cbs;
  a.b_total = rows * cbs;
  a.tab = tab;
  a.sb_in = sb_in;
  a.sb_out = sb_out;
  a.prior = prior;
  a.prior_const = prior_const;
  a.out = out;
  a.k = k;
  a.rows_il = (k + 4 + NCOLS - 1) / NCOLS;
  a.nd = a.rows_il * NCOLS - (k + 4);
  a.row_tiles = (a.rows_il + TILE_ROWS - 1) / TILE_ROWS;
  const long long blocks =
      3LL * a.row_tiles * ((a.b_total + TILE_CBS - 1) / TILE_CBS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (llr_int8)
    return metric_bf16 ? launch<int8_t, __nv_bfloat16>(a, blocks, st)
                       : launch<int8_t, float>(a, blocks, st);
  return metric_bf16 ? launch<float, __nv_bfloat16>(a, blocks, st)
                     : launch<float, float>(a, blocks, st);
}
