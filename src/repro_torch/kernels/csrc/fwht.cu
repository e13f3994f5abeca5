// Normalized fast Walsh--Hadamard transform along the last axis of an
// (n, d) float32 matrix, d any power of two.
//
// Replaces: src/repro/kernels/fwht.py, _fwht_kernel launched by _fwht_jit
// (the Pallas kernel that holds a (tile_n, d) block in VMEM and runs all
// log2(d) butterfly stages on it before writing back).
//
// What bounds it on an H100: bytes.  The transform reads every value once
// and writes it once (8 bytes an element); its n d log2(d) additions are a
// small share of what the card's float32 units do in the same time.  So
// every variant loads a row with 16-byte vectors (neighbouring lanes on
// neighbouring addresses), runs the butterflies in registers and warp
// shuffles, and writes each value once.  Shared memory is used only where
// a row is longer than a warp holds, and then once, not a barrier a stage.
//
// Stage order.  Stage h pairs element i with i + h inside blocks of 2h,
// h = 1, 2, 4, ..., d / 2, as the plain version (ref.fwht_ref) and the JAX
// package run them.  Every variant runs the stages in that order, rounds
// a + b and a - b as the plain version does (no contraction: there is no
// product), and divides once by sqrt(d) rounded to float32 with an IEEE
// division.  So the card's transform equals the plain version's bit for
// bit, and a fit on the card sees the same transformed data as its replay
// on the CPU.
//
// Variants, chosen by fwht_plan in kernels/fwht.py, which passes the
// variant and its rows per block here (checked):
//   thread  d <= 16: a thread per row, 256 rows a block, every stage in
//           registers.
//   warp    32 <= d <= 1024: a warp per row, 8 rows a block.  Lane l holds
//           elements C l + 32 C g + c, C = min(4, d / 32) values loaded as
//           one vector, g < d / (32 C): the stages h < C run in registers
//           over c, C <= h < 32 C by __shfl_xor_sync across lanes, and
//           h >= 32 C in registers over g.  No shared memory, no barrier.
//   block   2048 <= d <= 32768: a block per row, a warp per 1024-element
//           chunk (M = d / 1024 warps).  Each warp runs the stages h < 1024
//           on its chunk as the warp variant does and stores the chunk in
//           shared memory; after ONE barrier, thread t takes the columns
//           r = t, t + 32 M, ... of the (M, 1024) chunk matrix and runs the
//           stages h >= 1024 in registers over its M values (conflict-free
//           reads, coalesced 4-byte stores).
//   d >= 65536 (a row beyond one block's shared memory): d = d1 d2 with
//           d2 = 32768.  Pass 1 is the block variant over the n d1 rows of
//           length d2 (stages h < d2, unnormalized); a strided pass then
//           runs, in place on the output, the stages h >= d2 over the d1
//           values at stride d2 of every column, a thread a column and
//           neighbouring threads on neighbouring columns, and divides by
//           sqrt(d).  Above d = 2^20 the strided stages take more than one
//           pass of at most 32 values.  Each pass reads and writes every
//           value, so such a row reaches at most half its bound (a cluster
//           of blocks sharing the row through distributed shared memory
//           would make it one pass).

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREAD_ROWS = 256;     // rows a block of the thread variant
constexpr int WARP_ROWS = 8;         // rows a block of the warp variant
constexpr int CHUNK = 1024;          // block variant: elements a warp holds
constexpr int STRIDED_THREADS = 256;
constexpr int MAX_LOG_STRIDED = 5;   // a strided pass combines <= 32 values
constexpr long long MAX_GRID = 2147483647LL;
constexpr int MAX_DEVICES = 64;

enum Variant { THREAD = 0, WARP_ROW = 1, BLOCK_ROW = 2 };

// the stages h = LO, 2 LO, ..., < HI over the register index of v: v[r]
// and v[r + h] for every r whose bit h is clear
template <int N, int LO, int HI>
__device__ __forceinline__ void reg_stages(float (&v)[N]) {
#pragma unroll
  for (int h = LO; h < HI; h <<= 1) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (!(r & h)) {
        const float a = v[r];
        const float b = v[r + h];
        v[r] = a + b;
        v[r + h] = a - b;
      }
    }
  }
}

// the stages over the lane bits: lanes l and l ^ m hold elements i and
// i + h of every register, the lower lane (bit m clear) element i
template <int N>
__device__ __forceinline__ void lane_stages(float (&v)[N], int lane) {
#pragma unroll
  for (int m = 1; m < WARP; m <<= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float o = __shfl_xor_sync(FULL, v[r], m);
      v[r] = upper ? o - v[r] : v[r] + o;
    }
  }
}

// C contiguous floats (1, 2 or 4, aligned to C floats) into v[0..C)
template <int C>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

// v[0..C) / norm into C contiguous floats
template <int C>
__device__ __forceinline__ void store_vec(float* p, const float* v,
                                          float norm) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(__fdiv_rn(v[0], norm), __fdiv_rn(v[1], norm),
                    __fdiv_rn(v[2], norm), __fdiv_rn(v[3], norm));
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) =
        make_float2(__fdiv_rn(v[0], norm), __fdiv_rn(v[1], norm));
  } else {
    *p = __fdiv_rn(v[0], norm);
  }
}

// d <= 16: a thread per row
template <int LOG_D>
__global__ void __launch_bounds__(THREAD_ROWS) fwht_thread_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long rows,
    float norm) {
  constexpr int D = 1 << LOG_D;
  constexpr int C = D < 4 ? D : 4;
  const long long row = (long long)blockIdx.x * THREAD_ROWS + threadIdx.x;
  if (row >= rows) return;
  float v[D];
#pragma unroll
  for (int g = 0; g < D / C; ++g) load_vec<C>(x + row * D + g * C, v + g * C);
  reg_stages<D, 1, D>(v);
#pragma unroll
  for (int g = 0; g < D / C; ++g)
    store_vec<C>(out + row * D + g * C, v + g * C, norm);
}

// 32 <= d <= 1024: a warp per row, lane l holding C l + 32 C g + c
template <int LOG_D>
__global__ void __launch_bounds__(WARP * WARP_ROWS) fwht_warp_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long rows,
    float norm) {
  constexpr int D = 1 << LOG_D;
  constexpr int V = D / WARP;            // values a lane holds
  constexpr int C = V < 4 ? V : 4;       // contiguous values a load
  constexpr int G = V / C;
  const int lane = threadIdx.x % WARP;
  const long long row =
      (long long)blockIdx.x * WARP_ROWS + threadIdx.x / WARP;
  if (row >= rows) return;               // the whole warp: one row
  const float* src = x + row * D + C * lane;
  float v[V];
#pragma unroll
  for (int g = 0; g < G; ++g) load_vec<C>(src + g * WARP * C, v + g * C);
  reg_stages<V, 1, C>(v);                // h = 1 .. C / 2
  lane_stages(v, lane);                  // h = C .. 16 C
  reg_stages<V, C, V>(v);                // h = 32 C .. d / 2
  float* dst = out + row * D + C * lane;
#pragma unroll
  for (int g = 0; g < G; ++g) store_vec<C>(dst + g * WARP * C, v + g * C,
                                           norm);
}

// 2048 <= d <= 32768: a block per row, a warp per 1024-element chunk, the
// chunks combined after one pass through shared memory
template <int LOG_M>
__global__ void __launch_bounds__(WARP << LOG_M) fwht_block_kernel(
    const float* __restrict__ x, float* __restrict__ out, float norm) {
  constexpr int M = 1 << LOG_M;          // chunks of the row
  constexpr int D = CHUNK * M;
  constexpr int T = WARP * M;            // threads
  extern __shared__ __align__(16) float s[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const long long row = blockIdx.x;
  const float* src = x + row * D + warp * CHUNK + 4 * lane;
  float v[WARP];                         // elements 4 lane + 128 g + c
#pragma unroll
  for (int g = 0; g < 8; ++g) load_vec<4>(src + g * 128, v + 4 * g);
  reg_stages<WARP, 1, 4>(v);
  lane_stages(v, lane);
  reg_stages<WARP, 4, WARP>(v);          // h = 1 .. 512 done
  float* sw = s + warp * CHUNK + 4 * lane;
#pragma unroll
  for (int g = 0; g < 8; ++g)
    *reinterpret_cast<float4*>(sw + g * 128) =
        make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
  __syncthreads();

  float* dst = out + row * D;
  for (int r = threadIdx.x; r < CHUNK; r += T) {
    float w[M];                          // element r + 1024 m
#pragma unroll
    for (int m = 0; m < M; ++m) w[m] = s[m * CHUNK + r];
    reg_stages<M, 1, M>(w);              // h = 1024 .. d / 2
#pragma unroll
    for (int m = 0; m < M; ++m) dst[m * CHUNK + r] = __fdiv_rn(w[m], norm);
  }
}

// The stages h = S, 2 S, ..., S (M / 2), S = 2^log_s, of rows whose
// stages h < S are done, in place: column q is the M values at stride S
// of one block of S M elements; neighbouring threads take neighbouring
// columns (S >= 256), so every load and store is coalesced.
template <int LOG_M>
__global__ void __launch_bounds__(STRIDED_THREADS) fwht_strided_kernel(
    float* data, long long columns, int log_s, float norm) {
  constexpr int M = 1 << LOG_M;
  const long long stride = 1LL << log_s;
  for (long long q = (long long)blockIdx.x * STRIDED_THREADS + threadIdx.x;
       q < columns; q += (long long)gridDim.x * STRIDED_THREADS) {
    float* p = data + ((q >> log_s) << (log_s + LOG_M)) + (q & (stride - 1));
    float w[M];
#pragma unroll
    for (int m = 0; m < M; ++m) w[m] = p[m * stride];
    reg_stages<M, 1, M>(w);
#pragma unroll
    for (int m = 0; m < M; ++m) p[m * stride] = __fdiv_rn(w[m], norm);
  }
}

int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

unsigned grid_of(long long items, int per_block) {
  const long long g = (items + per_block - 1) / per_block;
  return (unsigned)(g < MAX_GRID ? g : MAX_GRID);
}

// Dynamic shared memory above 48 KB must be allowed per kernel and
// device; ``allowed`` keeps, per device, whether it is.
template <int LOG_M>
int allow_block_smem() {
  static bool allowed[MAX_DEVICES];
  constexpr int smem = CHUNK * (1 << LOG_M) * sizeof(float);
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && allowed[dev]) return 0;
  err = cudaFuncSetAttribute((const void*)fwht_block_kernel<LOG_M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = true;
  return (int)err;
}

template <int LOG_M>
int launch_block(const float* x, float* out, long long rows, float norm,
                 cudaStream_t stream) {
  const int err = allow_block_smem<LOG_M>();
  if (err) return err;
  fwht_block_kernel<LOG_M>
      <<<(unsigned)rows, WARP << LOG_M,
         CHUNK * (1 << LOG_M) * sizeof(float), stream>>>(x, out, norm);
  return 0;
}

}  // namespace

// out = the transform of the rows of x (rows, d), divided by norm; the
// variant and its rows per block as kernels/fwht.py's fwht_plan gives them
// (an inconsistent pair is refused).  x and out 16-byte aligned.
extern "C" int fwht_rows_f32(const float* x, float* out, long long rows,
                             int d, int variant, int rows_per_block,
                             float norm, void* stream) {
  const int log_d = log2_exact(d);
  const cudaStream_t st = (cudaStream_t)stream;
  const int want = log_d < 0 ? -1 : log_d <= 4 ? THREAD
                 : log_d <= 10 ? WARP_ROW : log_d <= 15 ? BLOCK_ROW : -1;
  const int want_rows = want == THREAD ? THREAD_ROWS
                      : want == WARP_ROW ? WARP_ROWS : 1;
  if (want < 0 || variant != want || rows_per_block != want_rows ||
      rows < 0 || (rows + want_rows - 1) / want_rows > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const unsigned grid = grid_of(rows, want_rows);
  int err = 0;
  switch (log_d) {
#define THREAD_CASE(L) \
    case L: fwht_thread_kernel<L><<<grid, THREAD_ROWS, 0, st>>>(x, out, rows, norm); break;
    THREAD_CASE(0) THREAD_CASE(1) THREAD_CASE(2) THREAD_CASE(3)
    THREAD_CASE(4)
#undef THREAD_CASE
#define WARP_CASE(L) \
    case L: fwht_warp_kernel<L><<<grid, WARP * WARP_ROWS, 0, st>>>(x, out, rows, norm); break;
    WARP_CASE(5) WARP_CASE(6) WARP_CASE(7) WARP_CASE(8) WARP_CASE(9)
    WARP_CASE(10)
#undef WARP_CASE
#define BLOCK_CASE(L) \
    case L: err = launch_block<L - 10>(x, out, rows, norm, st); break;
    BLOCK_CASE(11) BLOCK_CASE(12) BLOCK_CASE(13) BLOCK_CASE(14)
    BLOCK_CASE(15)
#undef BLOCK_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// The grid, threads and dynamic shared memory, out[0..2], of the row pass
// over ``rows`` rows of length d (log_m = 0), or of the strided pass over
// ``rows`` columns of 2^log_m values, as the launchers here launch them.
// The launch plans that analysis.kernel_audit checks are held equal to it
// on the card.
extern "C" int fwht_geometry(long long rows, int d, int log_m,
                             unsigned* out) {
  if (log_m > 0) {
    out[0] = grid_of(rows, STRIDED_THREADS);
    out[1] = STRIDED_THREADS, out[2] = 0;
    return 0;
  }
  const int log_d = log2_exact(d);
  if (log_d < 0 || log_d > 15) return (int)cudaErrorInvalidValue;
  out[0] = grid_of(rows, log_d <= 4 ? THREAD_ROWS : log_d <= 10 ? WARP_ROWS
                                                                : 1);
  out[1] = log_d <= 4 ? THREAD_ROWS : log_d <= 10 ? WARP * WARP_ROWS
                                                  : WARP << (log_d - 10);
  out[2] = log_d <= 10 ? 0 : CHUNK * (1 << (log_d - 10)) * sizeof(float);
  return 0;
}

// In place on data (``columns`` 2^log_m columns, i.e. columns * 2^log_m
// floats): the stages h = 2^log_s .. 2^(log_s + log_m - 1), then / norm.
extern "C" int fwht_strided_f32(float* data, long long columns, int log_s,
                                int log_m, float norm, void* stream) {
  if (log_m < 1 || log_m > MAX_LOG_STRIDED || log_s < 8 || log_s > 40 ||
      columns < 0 || (columns & ((1LL << log_s) - 1)))
    return (int)cudaErrorInvalidValue;
  if (columns == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_of(columns, STRIDED_THREADS);
  switch (log_m) {
#define STRIDED_CASE(L) \
    case L: fwht_strided_kernel<L><<<grid, STRIDED_THREADS, 0, st>>>(data, columns, log_s, norm); break;
    STRIDED_CASE(1) STRIDED_CASE(2) STRIDED_CASE(3) STRIDED_CASE(4)
    STRIDED_CASE(5)
#undef STRIDED_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
