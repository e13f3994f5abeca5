// Normalized fast Walsh--Hadamard transform along the last axis of an
// (n, d) float32 matrix, d a power of two.
//
// Replaces: src/repro/kernels/fwht.py, _fwht_kernel launched by _fwht_jit
// (the Pallas kernel that holds a (tile_n, d) block in VMEM and runs all
// log2(d) butterfly stages on it before writing back).
//
// What bounds it on an H100: bytes.  The transform reads every value once
// and writes it once (8 bytes per element); its n*d*log2(d) additions are
// ~1/20 of what the card's float32 units could do in the same time.  So the
// design keeps every butterfly stage on chip: a block loads whole rows into
// shared memory with coalesced reads, runs the log2(d) stages there with a
// __syncthreads() between stages, and writes each row back once.  Short rows
// are grouped (ROW_TILE floats per block) so a block has enough butterflies
// to keep its threads busy.  A row longer than the block's shared memory
// (d * 4 bytes > 227 KB) is refused by the Python wrapper; that case needs a
// multi-pass variant through device memory.
//
// The sum order of every output element is the same as the plain version's
// (stage h pairs element i with i + h inside blocks of 2h), and the final
// scaling divides by sqrt(d) rounded to float32, as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int ROW_TILE = 2048;       // floats per block for rows d <= 2048
constexpr int MAX_THREADS = 1024;
constexpr int DEFAULT_SMEM = 48 * 1024;

__global__ void fwht_rows_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, long long n,
                                 int d, int log_d, int rows_per_block,
                                 float norm) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long rows_left = n - row0;
  const int rows = rows_left < rows_per_block ? (int)rows_left
                                              : rows_per_block;
  const int count = rows_per_block * d;   // floats held by this block
  const int valid = rows * d;             // floats that belong to real rows
  const float* src = x + row0 * d;

  for (int i = tid; i < count; i += nthreads) {
    tile[i] = i < valid ? src[i] : 0.0f;
  }
  __syncthreads();

  const int pairs = count >> 1;
  for (int log_h = 0; log_h < log_d; ++log_h) {
    const int h = 1 << log_h;
    for (int p = tid; p < pairs; p += nthreads) {
      // pair p: row p / (d/2), then butterfly q inside the row
      const int row = p >> (log_d - 1);
      const int q = p & ((d >> 1) - 1);
      const int i = row * d + ((q >> log_h) << (log_h + 1)) + (q & (h - 1));
      const float a = tile[i];
      const float b = tile[i + h];
      tile[i] = a + b;
      tile[i + h] = a - b;
    }
    __syncthreads();
  }

  float* dst = out + row0 * d;
  for (int i = tid; i < valid; i += nthreads) {
    dst[i] = tile[i] / norm;
  }
}

}  // namespace

extern "C" int fwht_rows_f32(const float* x, float* out, long long n, int d,
                             float norm, void* stream) {
  int log_d = 0;
  while ((1 << log_d) < d) ++log_d;
  const int rows_per_block = d < ROW_TILE ? ROW_TILE / d : 1;
  const int count = rows_per_block * d;
  int threads = count / 2;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)count * sizeof(float);
  if (smem > DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        fwht_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0) {
    fwht_rows_kernel<<<(unsigned)blocks, threads, smem,
                       (cudaStream_t)stream>>>(x, out, n, d, log_d,
                                               rows_per_block, norm);
  }
  return (int)cudaGetLastError();
}
