// The kernels of the saddle step.
//
// PACKED (the production step, 2 launches per step): leading slot axis S,
// x_t (S, d, n_pad), idx (S, b), point vectors (S, n_pad) and per-slot
// scalars (S,).  Each wrapper call is ONE launch, grid (point block,
// slot), and its outputs are final: no torch op runs after it.
//
// Replaces: src/repro/kernels/saddle_update.py,
//   _momentum_dot_packed_kernel (launched by _momentum_dot_packed_jit) and
//   _mwu_packed_kernel (launched by _mwu_update_packed_jit), together with
//   the merges of per-tile partials that the JAX wrappers run outside
//   their pallas_call.
//
// What bounds them on an H100: bytes.  A step reads the b sampled rows of
// x_t (b * n_pad floats, gathered by index) and a few point-length
// vectors, about one multiply-add per float read: at b = 128 and
// n_pad = 20,096 that is 10.3 MB, 3.1 us at 3.35 TB/s.  Nearing it takes
// the whole gather in flight at once, which the float4 loads of a
// one-warp block cannot keep, and one launch, since a launch costs
// microseconds of device time and more of the host's.  At b = 1 the bytes
// are nothing and the launch and its chain of dependent reads are all.
// So:
//
//   * A point tile is LANE = 128 points: a warp holds it as one float4 a
//     lane.  n_pad is a multiple of 128 (the wrapper checks), so no lane
//     is masked.  A block has 8 warps over T tiles (T = 8 / G, chosen by b
//     in the wrapper: T = 8 at b = 1, T = 1 from b = 8): warp w takes tile
//     w % T of the block and the ROW GROUP w / T, the rows j = g mod G.
//   * Staging: the block's segment of every sampled row (T * 512 bytes,
//     16-byte aligned) is copied into shared memory by the Tensor Memory
//     Accelerator (cp.async.bulk, one per row, issued by warp 0), into a
//     ring of up to 4 stages of 16 KB (32 / T rows a stage), each stage
//     completing on an mbarrier that expects its bytes.  At b <= 128 every
//     row of the block is in flight at once (64 KB); a larger b refills a
//     stage once all warps are done with it.  The warps read rows from
//     shared memory while later stages are still arriving.
//   * Any b from 1 to d: after the ring the block keeps the sampled rows'
//     indices (dot) or dw (MWU) in shared memory, all b of them up to
//     CHUNK_ROWS = 32,768 (128 KB), else a chunk of CHUNK_ROWS at a time,
//     reloaded by the whole block at the stage where the next chunk
//     starts (the ring's copies take their row indices from global
//     memory, so they need not wait).  The rows are summed in the same
//     order either way.
//   * Reductions across blocks happen inside the kernel, in a fixed
//     order: each block writes per-tile partials to scratch, fences, and
//     takes an integer ticket from its slot's counter (atomicAdd); the
//     block that draws the last ticket merges the slot's partials in tile
//     order and resets the counter to 0 for the next launch.  Only the
//     ticket is atomic, so the merged floats do not depend on which block
//     finishes last: a repeat call gives the same bits.  (A thread block
//     cluster holds at most 16 blocks; the paths have 3 to 391 tiles.)
//     A slot of one block (3 or 4 tiles at b = 1) takes no ticket.  The
//     counters and scratch belong to the wrapper, one set per device, so
//     the packed kernels assume one stream at a time.
//   * momentum_dot_packed computes the block's momentum once into shared
//     memory; each warp dots its rows with its tile's momentum (warp
//     shuffle sum) into per-tile partials (S, tiles, b rounded up to 4);
//     the last block copies them into its ring by bulk copies, a piece at
//     a time, and sums them over tiles, float4 columns by a fixed striping
//     and a fixed tree, into delta (S, b).
//   * mwu_update_packed: each warp sums dw_j x_t[idx_j] over its row group
//     in registers; the row groups' dv are added in shared memory in warp
//     order; one warp a tile then writes log_new and u_new and the tile's
//     per-class (max, sum exp(log_new - max)); the last block merges the
//     tiles' partials (one warp: lane l takes tiles l, l + 32, ..., then a
//     shuffle tree; the max first, then the sum of s exp(m_tile - max))
//     into m (S, 2) and s (S, 2), lse = m + log(s).
//
// Padding lanes carry sign 0 and log weight -1e30, whose expf is exactly 0.
// Per-class max / sum-exp partials are masked by sign, so a tile with no
// point of a class gives (NEG, 0) for it -- never (NEG, inf).
//
// A sampled row index outside [0, d) is never read, not even by a bulk
// copy: the copy takes row 0 instead, and the dot of that row, or the
// slot's whole dv, becomes NaN, so the caller's outputs are NaN (the
// solver's health flags then stop the slot) instead of an illegal memory
// access that would poison the CUDA context.
//
// UNPACKED (the per-class reference step, 4 launches per step): cols
// (K, n, B) row-major -- the step's B sampled coordinates of each of a
// client's n points, gathered by the caller -- point vectors (K, n), with
// K clients (K = 1 serially).  Any n is taken: a block's last points are
// masked in the kernel (they touch no sum, max or store), where the JAX
// wrapper pads with a copy at log weight -1e30.
//
// Replaces: src/repro/kernels/saddle_update.py,
//   _momentum_dot_kernel (launched by _momentum_dot_jit, :233) and
//   _mwu_kernel (:254, launched by _mwu_update_jit, :287), together with
//   the merges of per-tile partials that the JAX wrappers run outside
//   their pallas_call.
//
// Bound on an H100: bytes again (cols is read once, ~2 flops a float); at
// the reference step's sizes (K = 20 clients of 250 points) the launch and
// the latency of a few dependent reads are all.
//   * momentum_dot: ONE launch whose output is delta (K, B) itself.  Grid
//     (point block, column chunk, client); the wrapper's geometry puts
//     lpr lanes on a row (4 columns a lane, a chunk of 4 lpr columns) and
//     takes the widest rows for which one block's loads (8 rows a lane)
//     hold the client's points: up to 1,024 points at B >= 5 and 2,048
//     at B <= 4 take one block per chunk, which writes delta with no
//     merge.  The block computes its points' momentum once (two expf
//     each); at B = 1 every thread dots its points, else each lane reads
//     its float4 of a row (one 16-byte load when B % 4 == 0), summing in
//     registers; the rows' sums meet by a shuffle tree and the warps' in
//     warp order.  A longer client's point blocks merge inside the launch
//     as the packed kernels' do: per-block partials in the wrapper's
//     workspace, an integer ticket per (client, chunk), the last block
//     summing in block order.  No float atomics.
//   * mwu_update: ONE launch whose outputs are final: log_new (normalised
//     or not), u_new and (m, s) (2, K).  Its bound is bytes,
//     4 K (n (B + 4) + B + 2) over 3.35 TB/s: 0.79 us at K = 20, n = 251,
//     B = 128, 0.03 us at B = 1.  At these sizes the launch and the DRAM
//     latency of each dependent step are all, so the design spends as few
//     of them as it can.  Grid (point block, client) from the wrapper's
//     mwu_update_geometry: a block takes ``pts`` points (at most
//     MWU_POINTS, whose dv, log_lam and u fit its shared memory), lpr
//     lanes a row and 4 columns a lane (one 16-byte load when B % 4 == 0),
//     each lane with DOT_UNROLL rows' loads in flight and the next batch's
//     issued before the current one is used; a lane's dw is read once a
//     block into registers (a row wider than 4 lpr columns takes passes,
//     whose later dw come from L1).  Blocks split by points only, since
//     each point's epilogue needs its whole dv; a client of up to two
//     rounds is one block, a longer one a block a round, so that its
//     bytes are spread over several SMs (one SM alone moves a 128 KB
//     client in no less than ~4 us).  The block's log_lam and u are copied
//     to shared memory by cp.async while the rows arrive, so the epilogue
//     waits on no second DRAM latency.  A row's lanes meet by a shuffle
//     tree (the U rows' trees interleaved); the epilogue (a thread a
//     point, coalesced stores) keeps log_new in shared memory and reduces
//     the block's max and sum of exp(log_new - max) in a fixed order:
//     shuffle trees, then warps in warp order.  A client of one block
//     writes (m, s), and with ``normalize`` log_new - (m + log s), itself:
//     no merge.  A client of several blocks writes per-block partials to
//     the workspace and takes an integer ticket by one acquire-release
//     atomic (no separate fences: the merge costs ~1 us of latency, three
//     round trips to L2); the last block merges the partials in block
//     order (m the max of the m_p, s the sum of s_p exp(m_p - m), the JAX
//     wrapper's merge), resets the counter and, with ``normalize``,
//     rewrites the client's log_new, read back from L2.  No float atomics:
//     a repeat call gives the same bits.
//   * The step scalars arrive as floats; c = 1 / (gamma + d_eff / tau) is
//     computed in float32 inside, as the Pallas kernel does, and the
//     elementwise arithmetic is rounded op by op (__fmul_rn / __fadd_rn,
//     no fused multiply-add) so the plain version repeats it exactly.
//   * Round-robin padding points of a client shard carry log weight -1e30
//     and zero rows: exp gives 0 momentum, and c * (d_eff / tau) <= 1 keeps
//     their log_new finite near -1e30, so they add exactly 0 to the sums.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANE = 128;           // points per tile (one warp x float4)
constexpr int WARP = 32;
constexpr int THREADS = 256;        // threads per block, every kernel here
constexpr int WARPS = THREADS / WARP;
constexpr int STAGE_FLOATS = 4096;  // one 16 KB stage of the row ring
constexpr int MAX_STAGES = 4;       // ring depth: 64 KB
constexpr int CHUNK_ROWS = 32768;   // sampled rows whose indices (dot) or
                                    // dw (MWU) a packed block holds in
                                    // shared memory at once, after the ring
constexpr int MAX_SMEM = 232448;    // shared memory a block may use (227 KB)
static_assert(CHUNK_ROWS % (STAGE_FLOATS / LANE) == 0,
              "a chunk ends where a stage of the ring ends, at any T");
static_assert(MAX_STAGES * STAGE_FLOATS * 4 + CHUNK_ROWS * 4 + 8192 <=
                  MAX_SMEM,
              "the ring and one chunk, beside the kernels' static shared "
              "memory (under 8 KB), fit a block");
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ------------------------------------------------ mbarrier and bulk copy
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared, ``bytes`` a multiple of 16, both ends 16-byte aligned;
// completes ``bytes`` of the mbarrier's expected transaction count
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The ring of row stages of one packed block (see the header).  Stage k
// holds rows [k * rows, (k + 1) * rows) of the slot's b sampled rows, in
// buffer k % nbuf, completing on full[k % nbuf] in phase k / nbuf.
struct RowRing {
  float* buf;            // nbuf * STAGE_FLOATS floats of dynamic smem
  uint64_t* full;        // nbuf mbarriers, then the merge's
  const float* xs;       // x_t[s, 0, first point of the block]
  const int* ids;        // idx[s, :]
  int d, n_pad, b;
  int tpb;               // tiles per block, T
  int rows;              // rows per stage, 32 / T
  int stages, nbuf;
  unsigned row_bytes;    // tiles_here * 512: one row's copy

  // by warp 0: arm stage k's barrier, then one bulk copy a row, lane r
  // copying the stage's row r, whose index is ``row``; an index outside
  // [0, d) copies row 0
  __device__ void issue(int k, int lane, int row) const {
    const int n = min(rows, b - k * rows);
    uint64_t* bar = &full[k % nbuf];
    if (lane == 0) mbar_expect_tx(bar, n * row_bytes);
    __syncwarp();
    if (lane < n) {
      const int safe = (unsigned)row < (unsigned)d ? row : 0;
      bulk_copy(buf + (k % nbuf) * STAGE_FLOATS + lane * tpb * LANE,
                xs + (size_t)safe * n_pad, row_bytes, bar);
    }
  }

  // the index of stage k's row ``lane`` (0 past the last row)
  __device__ int row_of(int k, int lane) const {
    const int j = k * rows + lane;
    return lane < rows && j < b ? ids[j] : 0;
  }

  // by warp 0, first thing in the block: init the barriers (the ring's
  // and the merge's, full[nbuf]), read the
  // indices of the first nbuf stages at once, start their copies (the
  // caller syncs the block before any wait)
  __device__ void start(int lane) const {
    if (lane == 0) {
      for (int i = 0; i <= nbuf; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    int row[MAX_STAGES];
#pragma unroll
    for (int k = 0; k < MAX_STAGES; ++k)
      row[k] = k < nbuf ? row_of(k, lane) : 0;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < MAX_STAGES; ++k)
      if (k < nbuf) issue(k, lane, row[k]);
  }

  // every thread: for each stage, wait for it, call fn(j, c, x) for the
  // rows j of row group g, c = j % CHUNK_ROWS the row's place in the
  // block's chunk of indices or dw, x the float4 of the lane's points of
  // its tile in row j, then refill the stage once every warp is done with
  // it.  Where a stage starts a new chunk (b > CHUNK_ROWS only; chunks end
  // on stage boundaries), every warp is first done with the last chunk
  // and reload(j0) fills the chunk of rows from j0.  The ring's copies
  // read their row indices from global memory, so stages in flight do
  // not wait for the reload.
  template <class Reload, class Fn>
  __device__ void walk(int g, int groups, int tile, bool active,
                       Reload reload, Fn fn) const {
    const int lane = threadIdx.x % WARP;
    for (int k = 0; k < stages; ++k) {
      const int j0 = k * rows;
      if (j0 > 0 && j0 % CHUNK_ROWS == 0) {
        __syncthreads();
        reload(j0);
        __syncthreads();
      }
      mbar_wait(&full[k % nbuf], (k / nbuf) & 1);
      const int n = min(rows, b - j0);
      const int c0 = j0 % CHUNK_ROWS;
      const float* st = buf + (k % nbuf) * STAGE_FLOATS + tile * LANE +
                        lane * 4;
      if (active) {
#pragma unroll 4
        for (int r = g; r < n; r += groups)
          fn(j0 + r, c0 + r, load4(st + r * tpb * LANE));
      }
      if (k + nbuf < stages) {
        __syncthreads();
        if (threadIdx.x < WARP) {
          const int row = row_of(k + nbuf, lane);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue(k + nbuf, lane, row);
        }
      }
    }
  }

  // by warp 0, once the walk is over and the block synced: copy rows
  // [p0, p0 + n) x floats [c0, c0 + w) of the row-major (rows, width)
  // matrix at src, written by other blocks, into the ring as (n, w),
  // completing on the merge's barrier: one bulk copy when the rows are
  // whole, else one a row
  __device__ void fetch(const float* src, int width, int p0, int n, int c0,
                        int w, int lane) const {
    uint64_t* bar = &full[nbuf];
    asm volatile("fence.proxy.async;" ::: "memory");
    if (lane == 0) mbar_expect_tx(bar, n * w * sizeof(float));
    __syncwarp();
    if (w == width) {
      if (lane == 0)
        bulk_copy(buf, src + (size_t)p0 * width, n * w * sizeof(float), bar);
    } else {
      for (int r = lane; r < n; r += WARP)
        bulk_copy(buf + r * w, src + (size_t)(p0 + r) * width + c0,
                  w * sizeof(float), bar);
    }
  }
};

__device__ __forceinline__ RowRing make_ring(
    float* buf, uint64_t* full, const float* x_t, const int* idx, int s,
    int tile0, int tiles_here, int d, int n_pad, int b, int tpb, int nbuf) {
  RowRing R;
  R.buf = buf;
  R.full = full;
  R.xs = x_t + (size_t)s * d * n_pad + (size_t)tile0 * LANE;
  R.ids = idx + (size_t)s * b;
  R.d = d;
  R.n_pad = n_pad;
  R.b = b;
  R.tpb = tpb;
  R.rows = STAGE_FLOATS / (tpb * LANE);
  R.stages = (b + R.rows - 1) / R.rows;
  R.nbuf = nbuf;
  R.row_bytes = (unsigned)tiles_here * LANE * sizeof(float);
  return R;
}

// The block's ticket on its slot's counter: true in the block that
// finishes last.  The block's partials are written before the call; the
// barrier and thread 0's fence order them before the ticket.  A slot of
// one block takes no ticket: the barrier alone makes its partials
// visible to it.
__device__ __forceinline__ bool last_block(int* counter, int* flag) {
  __syncthreads();
  if (gridDim.x == 1) return true;
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();      // see the other blocks' partials
  return true;
}

__device__ __forceinline__ float momentum(float lg, float lg_prev, float sg,
                                          float theta) {
  const float lam = expf(lg);
  const float lam_prev = expf(lg_prev);
  return sg * (lam + theta * (lam - lam_prev));
}

// delta[s, j] = sum over points i of
//   sign_i (lam_i + theta (lam_i - lam_prev_i)) x_t[s, idx[s, j], i].
// parts (S, tiles, bp) is scratch, bp = b rounded up to 4; counters (S,)
// are 0 before and after the launch.
__global__ void __launch_bounds__(THREADS) momentum_dot_packed_kernel(
    const float* __restrict__ x_t, const int* __restrict__ idx,
    const float* __restrict__ log_lam, const float* __restrict__ log_prev,
    const float* __restrict__ sign, const float* __restrict__ theta,
    float* __restrict__ out, float* __restrict__ parts,
    int* __restrict__ counters, int d, int n_pad, int b, int tpb,
    int nbuf) {
  extern __shared__ __align__(128) float ring[];
  __shared__ uint64_t full[MAX_STAGES + 1];
  __shared__ float4 vec[THREADS];           // momentum, then merge sums
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int lane = t % WARP;
  const int warp = t / WARP;
  const int s = blockIdx.y;
  const int tiles = n_pad / LANE;
  const int tile0 = blockIdx.x * tpb;
  const int tiles_here = min(tpb, tiles - tile0);
  const RowRing R = make_ring(ring, full, x_t, idx, s, tile0, tiles_here,
                              d, n_pad, b, tpb, nbuf);
  // the block's point operands are read first, so that their loads
  // overlap warp 0's start of the ring; float4 t of the block's points
  const bool mine = t < tiles_here * WARP;
  const size_t pt = (size_t)s * n_pad + (size_t)tile0 * LANE + t * 4;
  float4 lg, lp, sg;
  if (mine) {
    lg = load4(log_lam + pt);
    lp = load4(log_prev + pt);
    sg = load4(sign + pt);
  }
  if (warp == 0) R.start(lane);

  // the rows' indices, after the ring, for the range check of each dot
  // (by warps 1-7, while warp 0 starts the ring): the first chunk of
  // CHUNK_ROWS, the later ones loaded by the walk
  int* ids_s = reinterpret_cast<int*>(ring + nbuf * STAGE_FLOATS);
  const int* ids_g = idx + (size_t)s * b;
  if (warp > 0) {
    for (int j = t - WARP; j < min(b, CHUNK_ROWS); j += THREADS - WARP)
      ids_s[j] = ids_g[j];
  }
  // the block's momentum, once
  if (mine) {
    const float th = theta[s];
    vec[t] = make_float4(momentum(lg.x, lp.x, sg.x, th),
                         momentum(lg.y, lp.y, sg.y, th),
                         momentum(lg.z, lp.z, sg.z, th),
                         momentum(lg.w, lp.w, sg.w, th));
  }
  __syncthreads();                          // also publishes the barriers

  const int tile = warp % tpb;
  const int groups = WARPS / tpb;
  const bool active = tile < tiles_here;
  const float4 mom = active ? vec[tile * WARP + lane]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int bp = (b + 3) & ~3;
  float* part = parts + ((size_t)s * tiles + tile0 + tile) * bp;
  R.walk(warp / tpb, groups, tile, active,
         [&](int j0) {
           for (int j = t; j < min(CHUNK_ROWS, b - j0); j += THREADS)
             ids_s[j] = ids_g[j0 + j];
         },
         [&](int j, int c, float4 xv) {
           float acc = xv.x * mom.x + xv.y * mom.y + xv.z * mom.z +
                       xv.w * mom.w;
           acc = warp_sum(acc);
           if (lane == 0)
             part[j] = (unsigned)ids_s[c] < (unsigned)d ? acc : nan_f32();
         });
  // the partials are read back by bulk copies (the async proxy)
  asm volatile("fence.proxy.async.global;" ::: "memory");
  if (!last_block(counters + s, &is_last)) return;

  // delta[s, :] = the sum over tiles: thread t takes float4 column c of a
  // chunk of up to 256 and the tile rows q, q + Q, ... of each piece of
  // the partials staged in the ring; the Q stripes are then added by a
  // fixed tree
  const float* ps = parts + (size_t)s * tiles * bp;
  const int groups4 = bp / 4;
  unsigned phase = 0;
  for (int c0 = 0; c0 < groups4; c0 += THREADS) {
    const int cg = min(THREADS, groups4 - c0);
    const int w = cg * 4;
    const int per = nbuf * STAGE_FLOATS / w;  // tile rows a piece
    const int stripes = min(THREADS / cg, tiles);
    const int c = t % cg;
    const int q = t / cg;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p0 = 0; p0 < tiles; p0 += per) {
      const int n = min(per, tiles - p0);
      if (warp == 0) R.fetch(ps, bp, p0, n, c0 * 4, w, lane);
      mbar_wait(&full[nbuf], phase);
      phase ^= 1;
      if (q < stripes) {
#pragma unroll 4
        for (int r = q; r < n; r += stripes)
          acc = add4(acc, load4(ring + r * w + c * 4));
      }
      __syncthreads();                      // the ring is free again
    }
    vec[t] = acc;
    __syncthreads();
    for (int live = stripes; live > 1;) {
      const int half = (live + 1) / 2;
      if (q < live - half) vec[t] = add4(vec[t], vec[t + half * cg]);
      __syncthreads();
      live = half;
    }
    if (q == 0) {
      const float4 v = vec[t];
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (c0 + c) * 4 + e;
        if (j < b) out[(size_t)s * b + j] = vals[e];
      }
    }
    __syncthreads();
  }
  if (t == 0) counters[s] = 0;
}

__device__ __forceinline__ void class_partials(float ln, float sg, float& mp,
                                               float& mm) {
  mp = fmaxf(mp, sg > 0.0f ? ln : NEG);
  mm = fmaxf(mm, sg < 0.0f ? ln : NEG);
}

__device__ __forceinline__ void class_sums(float ln, float sg, float mp,
                                           float mm, float& sp, float& sm) {
  if (sg > 0.0f) sp += expf(ln - mp);
  if (sg < 0.0f) sm += expf(ln - mm);
}

// dv_i = sum_j dw[s, j] x_t[s, idx[s, j], i];  v = sign (u + d_eff dv);
// log_new = mwu_c (mwu_dot log_lam - v);  u_new = u + dv;
// ms = (m (S, 2), s (S, 2)), the per-class (+, -) max and sum of
// exp(log_new - max) over the slot.  parts (S, tiles, 4) is scratch;
// counters (S,) are 0 before and after the launch.
__global__ void __launch_bounds__(THREADS) mwu_update_packed_kernel(
    const float* __restrict__ x_t, const int* __restrict__ idx,
    const float* __restrict__ dw, const float* __restrict__ log_lam,
    const float* __restrict__ u, const float* __restrict__ sign,
    const float* __restrict__ mwu_c, const float* __restrict__ mwu_dot,
    float d_eff, float* __restrict__ log_new, float* __restrict__ u_new,
    float* __restrict__ ms, float* __restrict__ parts,
    int* __restrict__ counters, int d, int n_pad, int b, int tpb,
    int nbuf) {
  extern __shared__ __align__(128) float ring[];
  __shared__ uint64_t full[MAX_STAGES + 1];
  __shared__ float4 red[THREADS];           // dv of each warp
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int lane = t % WARP;
  const int warp = t / WARP;
  const int s = blockIdx.y;
  const int tiles = n_pad / LANE;
  const int tile0 = blockIdx.x * tpb;
  const int tiles_here = min(tpb, tiles - tile0);
  const RowRing R = make_ring(ring, full, x_t, idx, s, tile0, tiles_here,
                              d, n_pad, b, tpb, nbuf);
  // warp w < tiles_here writes tile w of the block: its operands are
  // read first, so that their loads overlap warp 0's start of the ring
  const bool writer = warp < tiles_here;
  const size_t pt = (size_t)s * n_pad + (size_t)(tile0 + warp) * LANE +
                    lane * 4;
  float4 sg, uu, lg;
  if (writer) {
    sg = load4(sign + pt);
    uu = load4(u + pt);
    lg = load4(log_lam + pt);
  }
  if (warp == 0) R.start(lane);

  // dw after the ring (its first chunk of CHUNK_ROWS, the later ones
  // loaded by the walk), and whether any row index is out of range (by
  // warps 1-7, while warp 0 starts the ring)
  float* dw_s = ring + nbuf * STAGE_FLOATS;
  const float* dw_g = dw + (size_t)s * b;
  bool bad = false;
  if (warp > 0) {
    for (int j = t - WARP; j < b; j += THREADS - WARP) {
      if (j < CHUNK_ROWS) dw_s[j] = dw_g[j];
      bad = bad || (unsigned)idx[(size_t)s * b + j] >= (unsigned)d;
    }
  }
  bad = __syncthreads_or(bad);              // also publishes the barriers

  const int tile = warp % tpb;
  const int groups = WARPS / tpb;
  float4 dv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // each row group's dv sums its rows in the order j = g, g + G, ...
  // across chunk boundaries, as one buffer of all b rows would
  R.walk(warp / tpb, groups, tile, tile < tiles_here,
         [&](int j0) {
           for (int j = t; j < min(CHUNK_ROWS, b - j0); j += THREADS)
             dw_s[j] = dw_g[j0 + j];
         },
         [&](int, int c, float4 xv) {
           const float w = dw_s[c];
           dv.x += xv.x * w;
           dv.y += xv.y * w;
           dv.z += xv.z * w;
           dv.w += xv.w * w;
         });
  red[t] = dv;
  __syncthreads();

  if (writer) {
    // row groups in order: warp g * tpb + w holds group g of tile w
    dv = red[warp * WARP + lane];
    for (int g = 1; g < groups; ++g)
      dv = add4(dv, red[(g * tpb + warp) * WARP + lane]);
    if (bad) {
      const float nan = nan_f32();
      dv = make_float4(nan, nan, nan, nan);
    }
    const float c = mwu_c[s];
    const float dot = mwu_dot[s];
    float4 ln, un;
    ln.x = c * (dot * lg.x - sg.x * (uu.x + d_eff * dv.x));
    ln.y = c * (dot * lg.y - sg.y * (uu.y + d_eff * dv.y));
    ln.z = c * (dot * lg.z - sg.z * (uu.z + d_eff * dv.z));
    ln.w = c * (dot * lg.w - sg.w * (uu.w + d_eff * dv.w));
    un.x = uu.x + dv.x;
    un.y = uu.y + dv.y;
    un.z = uu.z + dv.z;
    un.w = uu.w + dv.w;
    store4(log_new + pt, ln);
    store4(u_new + pt, un);

    float mp = NEG, mm = NEG;
    class_partials(ln.x, sg.x, mp, mm);
    class_partials(ln.y, sg.y, mp, mm);
    class_partials(ln.z, sg.z, mp, mm);
    class_partials(ln.w, sg.w, mp, mm);
    mp = warp_max(mp);
    mm = warp_max(mm);
    float sp = 0.0f, sm = 0.0f;
    class_sums(ln.x, sg.x, mp, mm, sp, sm);
    class_sums(ln.y, sg.y, mp, mm, sp, sm);
    class_sums(ln.z, sg.z, mp, mm, sp, sm);
    class_sums(ln.w, sg.w, mp, mm, sp, sm);
    sp = warp_sum(sp);
    sm = warp_sum(sm);
    if (lane == 0)
      store4(parts + ((size_t)s * tiles + tile0 + warp) * 4,
             make_float4(mp, sp, mm, sm));
  }
  if (!last_block(counters + s, &is_last) || warp != 0) return;

  // the slot's tiles, lane l taking tiles l, l + 32, ... and a shuffle
  // tree: first each class's max m over the tiles, then the sum of the
  // tiles' s exp(m_tile - m) (as the plain merge_class_partials)
  const float4* ps = reinterpret_cast<const float4*>(parts) +
                     (size_t)s * tiles;
  float mp = NEG, mm = NEG;
  for (int p = lane; p < tiles; p += WARP) {
    const float4 q = __ldcg(ps + p);
    mp = fmaxf(mp, q.x);
    mm = fmaxf(mm, q.z);
  }
  mp = warp_max(mp);
  mm = warp_max(mm);
  float sp = 0.0f, sm = 0.0f;
  for (int p = lane; p < tiles; p += WARP) {
    const float4 q = __ldcg(ps + p);
    sp += q.y * expf(q.x - mp);
    sm += q.w * expf(q.z - mm);
  }
  sp = warp_sum(sp);
  sm = warp_sum(sm);
  if (lane == 0) {
    const int slots = gridDim.y;
    ms[2 * s] = mp;
    ms[2 * s + 1] = mm;
    ms[2 * (slots + s)] = sp;
    ms[2 * (slots + s) + 1] = sm;
    counters[s] = 0;
  }
}

constexpr int DOT_COLS = 128;       // most columns a momentum_dot block covers
constexpr int DOT_POINTS = 4096;    // most points a momentum_dot block (B > 1)
                                    // takes: their momentum, 16 KB of smem
constexpr int DOT_UNROLL = 8;       // rows whose loads a lane issues at once
constexpr int MWU_POINTS = 2048;    // most points a mwu_update block takes:
                                    // dv, log_lam and u, 24 KB of smem

__device__ __forceinline__ float neg_inf_f32() {
  return __int_as_float(0xff800000);
}

// lam + theta (lam - lam_prev), rounded op by op as the plain version
__device__ __forceinline__ float momentum_rn(float lg, float lg_prev,
                                             float theta) {
  const float lam = expf(lg);
  const float lam_prev = expf(lg_prev);
  return __fadd_rn(lam, __fmul_rn(theta, __fsub_rn(lam, lam_prev)));
}

__device__ __forceinline__ void dot_acc(float4& acc, float4 x, float m) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, m));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, m));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, m));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, m));
}

__device__ __forceinline__ float component(float4 q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// delta[k, j] = sum over client k's points i of cols[k, i, j] * mom_i,
// mom_i = lam_i + theta (lam_i - lam_prev_i).  Grid (point block, column
// chunk of 4 lpr columns, client), THREADS threads; ``pts`` points a
// block, ``lpr`` lanes on a row.  A thread issues the loads of DOT_UNROLL
// points (rows) at once.  ONE_COL (B = 1): each thread dots its points,
// their momentum computed where it is used.  Else each lane takes row
// l / lpr of its warp's rows and the 4 columns 4 (l % lpr) .. + 3 of the
// chunk (one float4 with VEC4), its first rows' loads issued before the
// block writes its momentum to shared memory; the rows' sums meet by a
// shuffle tree, the warps' in warp order.  A client of one point block writes delta
// itself; else each block writes its partial and the last block of the
// (client, chunk), found by an integer ticket, sums them in block order
// and resets the counter.
template <bool ONE_COL, bool VEC4>
__global__ void __launch_bounds__(THREADS) momentum_dot_kernel(
    const float* __restrict__ cols, const float* __restrict__ log_lam,
    const float* __restrict__ log_prev, float theta,
    float* __restrict__ out, float* __restrict__ parts,
    int* __restrict__ counters, int n, int b, int lpr, int pts) {
  constexpr int U = DOT_UNROLL;
  __shared__ float mom[ONE_COL ? 1 : DOT_POINTS];
  __shared__ float4 red[WARPS][WARP];
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int lane = t % WARP;
  const int warp = t / WARP;
  const int chunk = blockIdx.y;
  const int k = blockIdx.z;
  const int i0 = blockIdx.x * pts;
  const int tn = min(pts, n - i0);          // points of this block
  const int c0 = chunk * 4 * lpr;
  const int width = min(4 * lpr, b - c0);   // columns of this chunk
  const float* lg = log_lam + (size_t)k * n + i0;
  const float* lp = log_prev + (size_t)k * n + i0;
  const float* c = cols + ((size_t)k * n + i0) * b + c0;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (ONE_COL) {
    for (int r0 = t; r0 < tn; r0 += U * THREADS) {
      float xc[U], a[U], ap[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = r0 + u * THREADS;
        xc[u] = i < tn ? c[i] : 0.0f;
        a[u] = i < tn ? lg[i] : 0.0f;
        ap[u] = i < tn ? lp[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 + u * THREADS < tn)
          acc.x = __fadd_rn(acc.x,
                            __fmul_rn(xc[u], momentum_rn(a[u], ap[u], theta)));
      }
    }
    acc.x = warp_sum(acc.x);
  } else {
    const int rows = WARP / lpr;            // rows a warp takes at once
    const int step = WARPS * rows;      // rows the block takes at once
    const int grp = lane % lpr;
    const int left = width - 4 * grp;       // columns of the lane's float4
    const float* cg = c + 4 * grp;
    float4 x[U];
    // the lane's rows r0 + u step, u < U (zeros past the block or chunk)
    auto load_rows = [&](int r0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * step;
        const float* p = cg + (size_t)r * b;
        if (r >= tn || left <= 0) {
          x[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if constexpr (VEC4) {
          x[u] = load4(p);
        } else {
          x[u] = make_float4(p[0], left > 1 ? p[1] : 0.0f,
                             left > 2 ? p[2] : 0.0f, left > 3 ? p[3] : 0.0f);
        }
      }
    };
    int r0 = warp * rows + lane / lpr;
    load_rows(r0);
    for (int i0m = t; i0m < tn; i0m += U * THREADS) {
      float a[U], ap[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0m + u * THREADS;
        a[u] = i < tn ? lg[i] : 0.0f;
        ap[u] = i < tn ? lp[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0m + u * THREADS;
        if (i < tn) mom[i] = momentum_rn(a[u], ap[u], theta);
      }
    }
    __syncthreads();
    while (r0 < tn) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * step;
        if (r < tn) dot_acc(acc, x[u], mom[r]);
      }
      r0 += U * step;
      if (r0 < tn) load_rows(r0);
    }
    // lanes grp, grp + lpr, ... hold the same columns of other rows
    for (int off = lpr; off < WARP; off <<= 1) {
      acc.x += __shfl_xor_sync(FULL, acc.x, off);
      acc.y += __shfl_xor_sync(FULL, acc.y, off);
      acc.z += __shfl_xor_sync(FULL, acc.z, off);
      acc.w += __shfl_xor_sync(FULL, acc.w, off);
    }
  }
  if (lane < (ONE_COL ? 1 : lpr)) red[warp][lane] = acc;
  __syncthreads();
  float total = 0.0f;                        // column t of the chunk
  if (t < width) {
    for (int w = 0; w < WARPS; ++w)
      total = __fadd_rn(total, component(red[w][t / 4], t % 4));
  }
  float* dst = out + (size_t)k * b + c0;
  if (gridDim.x == 1) {
    if (t < width) dst[t] = total;
    return;
  }
  const size_t slot = (size_t)k * gridDim.y + chunk;
  float* ps = parts + slot * gridDim.x * DOT_COLS;
  if (t < width) ps[(size_t)blockIdx.x * DOT_COLS + t] = total;
  if (!last_block(counters + slot, &is_last)) return;
  if (t < width) {
    float sum = 0.0f;
    for (int p = 0; p < (int)gridDim.x; ++p)
      sum = __fadd_rn(sum, __ldcg(ps + (size_t)p * DOT_COLS + t));
    dst[t] = sum;
  }
  if (t == 0) counters[slot] = 0;
}

// global -> shared, 4 bytes, asynchronous (cp.async); completes at
// cp_async_wait_all in the issuing thread
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// acc + x . w, rounded op by op in column order
__device__ __forceinline__ float dot4_rn(float acc, float4 x, float4 w) {
  acc = __fadd_rn(acc, __fmul_rn(x.x, w.x));
  acc = __fadd_rn(acc, __fmul_rn(x.y, w.y));
  acc = __fadd_rn(acc, __fmul_rn(x.z, w.z));
  return __fadd_rn(acc, __fmul_rn(x.w, w.w));
}

// The block's max (MAX) or sum of v in a fixed order: each warp's shuffle
// tree, then the warps in warp order; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red,
                                              float* bc) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if (threadIdx.x % WARP == 0) red[threadIdx.x / WARP] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int w = 1; w < WARPS; ++w)
      r = MAX ? fmaxf(r, red[w]) : __fadd_rn(r, red[w]);
    *bc = r;
  }
  __syncthreads();
  return *bc;
}

// The client's ticket, with release and acquire semantics at gpu scope:
// the calling thread's earlier writes (and those the block's barrier
// ordered before it) are visible to the block that draws the last
// ticket, and that block sees every other block's.
__device__ __forceinline__ int ticket_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// dv_i = cols[k, i, :] . dw[k, :];  v = sign (u + d_eff dv);
// log_new = c ((d_eff / tau) log_lam - v), c = 1 / (gamma + d_eff / tau);
// u_new = u + dv;  ms (2, K) = (m, s), client k's max m of log_new and sum
// s of exp(log_new - m); with ``normalize`` log_new - (m + log s) is
// written in place of log_new.  Grid (point block of ``pts`` points,
// client), lpr lanes a row (see the header).  parts (K, blocks, 2) is
// scratch and counters (K,) are 0 before and after the launch, both used
// only when a client has more than one block.  Dynamic shared memory:
// 3 pts floats (dv then log_new, log_lam, u).  VEC4: B % 4 == 0 and cols
// 16-byte aligned, one float4 load a lane and row.
template <bool VEC4>
__global__ void __launch_bounds__(THREADS) mwu_update_kernel(
    const float* __restrict__ cols, const float* __restrict__ log_lam,
    const float* __restrict__ u, const float* __restrict__ dw, float sign,
    float gamma, float tau, float d_eff, int normalize,
    float* __restrict__ log_new, float* __restrict__ u_new,
    float* __restrict__ ms, float* __restrict__ parts,
    int* __restrict__ counters, int n, int b, int lpr, int pts) {
  constexpr int U = DOT_UNROLL;
  extern __shared__ __align__(16) float dyn[];
  float* val = dyn;                          // dv, then log_new
  float* lg_s = dyn + pts;
  float* u_s = dyn + 2 * pts;
  __shared__ float red[WARPS];
  __shared__ float bc;
  __shared__ float lse_s;                    // the merged m + log s
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int lane = t % WARP;
  const int warp = t / WARP;
  const int k = blockIdx.y;
  const int tn = min(pts, n - (int)blockIdx.x * pts);  // points here
  const size_t base = (size_t)k * n + (size_t)blockIdx.x * pts;

  // the epilogue's operands, while the rows arrive: thread t copies the
  // points it reads in the epilogue
  for (int i = t; i < tn; i += THREADS) {
    cp_async4(lg_s + i, log_lam + base + i);
    cp_async4(u_s + i, u + base + i);
  }

  // dv: lane l takes row l / lpr of its warp's rows and the columns
  // 4 (l % lpr) + 4 lpr p .. + 3 of pass p; U rows' loads at once, the
  // next batch's issued before the current one is used
  const int rows = WARP / lpr;               // rows a warp takes at once
  const int step = WARPS * rows;             // rows the block takes at once
  const int batch = U * step;
  const int grp = lane % lpr;
  const int passes = (b + 4 * lpr - 1) / (4 * lpr);
  const float* c = cols + base * b;
  const float* dwk = dw + (size_t)k * b;
  auto dw4 = [&](int p) {
    const int j = 4 * (grp + p * lpr);
    return make_float4(j < b ? dwk[j] : 0.0f, j + 1 < b ? dwk[j + 1] : 0.0f,
                       j + 2 < b ? dwk[j + 2] : 0.0f,
                       j + 3 < b ? dwk[j + 3] : 0.0f);
  };
  float4 x[U];
  // pass p of the lane's rows rb + l / lpr + v step (zeros past the block
  // or the row)
  auto load_rows = [&](int rb, int p) {
    const int j = 4 * (grp + p * lpr);
    const int left = b - j;                  // columns of the lane's float4
#pragma unroll
    for (int v = 0; v < U; ++v) {
      const int r = rb + lane / lpr + v * step;
      const float* q = c + (size_t)r * b + j;
      if (r >= tn || left <= 0) {
        x[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else if constexpr (VEC4) {
        x[v] = load4(q);
      } else {
        x[v] = make_float4(q[0], left > 1 ? q[1] : 0.0f,
                           left > 2 ? q[2] : 0.0f, left > 3 ? q[3] : 0.0f);
      }
    }
  };
  const float4 w0 = dw4(0);                  // the lane's dw, once a block
  const int rb0 = warp * rows;               // the warp's first row
  if (rb0 < tn) load_rows(rb0, 0);
  for (int rb = rb0; rb < tn; rb += batch) {  // uniform across the warp
    float acc[U];
#pragma unroll
    for (int v = 0; v < U; ++v) acc[v] = 0.0f;
    for (int p = 0; p < passes; ++p) {
      const float4 w = p == 0 ? w0 : dw4(p);
      float4 cur[U];
#pragma unroll
      for (int v = 0; v < U; ++v) cur[v] = x[v];
      if (p + 1 < passes) load_rows(rb, p + 1);
      else if (rb + batch < tn) load_rows(rb + batch, 0);
#pragma unroll
      for (int v = 0; v < U; ++v) acc[v] = dot4_rn(acc[v], cur[v], w);
    }
    // a row's lanes by a shuffle tree, the U rows' trees interleaved
#pragma unroll
    for (int off = 1; off < WARP; off <<= 1) {
      if (off < lpr) {
#pragma unroll
        for (int v = 0; v < U; ++v)
          acc[v] = __fadd_rn(acc[v], __shfl_xor_sync(FULL, acc[v], off));
      }
    }
#pragma unroll
    for (int v = 0; v < U; ++v) {
      const int r = rb + lane / lpr + v * step;
      if (grp == 0 && r < tn) val[r] = acc[v];
    }
  }
  cp_async_wait_all();
  __syncthreads();                           // every dv in val

  // the epilogue, a thread a point
  const float ratio = __fdiv_rn(d_eff, tau);
  const float cc = __fdiv_rn(1.0f, __fadd_rn(gamma, ratio));
  const bool one = gridDim.x == 1;
  const bool late = one && normalize;        // log_new written normalised
  float mx = neg_inf_f32();
  for (int i = t; i < tn; i += THREADS) {
    const float dv = val[i];
    const float uu = u_s[i];
    const float v = __fmul_rn(sign, __fadd_rn(uu, __fmul_rn(d_eff, dv)));
    const float ln = __fmul_rn(cc, __fsub_rn(__fmul_rn(ratio, lg_s[i]), v));
    u_new[base + i] = __fadd_rn(uu, dv);
    if (!late) log_new[base + i] = ln;
    val[i] = ln;
    mx = fmaxf(mx, ln);
  }
  // (the reductions' barriers also order the stores above before the
  // ticket that thread 0 may draw below)
  const float m = block_reduce<true>(mx, red, &bc);
  float sm = 0.0f;
  for (int i = t; i < tn; i += THREADS)
    sm = __fadd_rn(sm, expf(__fsub_rn(val[i], m)));
  const float s = block_reduce<false>(sm, red, &bc);

  if (one) {                                 // the client's whole (m, s)
    if (t == 0) {
      ms[k] = m;
      ms[gridDim.y + k] = s;
    }
    if (late) {
      const float lse = __fadd_rn(m, logf(s));
      for (int i = t; i < tn; i += THREADS)
        log_new[base + i] = __fsub_rn(val[i], lse);
    }
    return;
  }

  // several blocks: thread 0 writes the block's partial and draws the
  // ticket; the last block's warp 0 merges the partials in block order,
  // lane l holding blocks l, l + 32, ...
  const int nb = gridDim.x;
  float2* pk = reinterpret_cast<float2*>(parts) + (size_t)k * nb;
  if (warp == 0) {
    int ticket = 0;
    if (lane == 0) {
      pk[blockIdx.x] = make_float2(m, s);
      ticket = ticket_acq_rel(counters + k);
    }
    __syncwarp();                            // lane 0's acquire, for all
    const bool last = __shfl_sync(FULL, ticket, 0) == nb - 1;
    if (last) {
      const float2 none = make_float2(neg_inf_f32(), 0.0f);
      const float2 q0 = lane < nb ? __ldcg(pk + lane) : none;
      float mm = q0.x;
      for (int p = lane + WARP; p < nb; p += WARP)
        mm = fmaxf(mm, __ldcg(pk + p).x);
      mm = warp_max(mm);
      float ss = 0.0f;
      for (int p0 = 0; p0 < nb; p0 += WARP) {
        const int p = p0 + lane;
        const float2 q = p0 == 0 ? q0 : p < nb ? __ldcg(pk + p) : none;
        const float term =
            p < nb ? __fmul_rn(q.y, expf(__fsub_rn(q.x, mm))) : 0.0f;
        const int live = min(WARP, nb - p0);
        for (int l = 0; l < live; ++l)
          ss = __fadd_rn(ss, __shfl_sync(FULL, term, l));
      }
      if (lane == 0) {
        ms[k] = mm;
        ms[gridDim.y + k] = ss;
        counters[k] = 0;
        lse_s = __fadd_rn(mm, logf(ss));
      }
    }
    if (lane == 0) is_last = last;
  }
  if (!normalize) return;
  __syncthreads();
  if (!is_last) return;
  // normalise every block's log_new of the client, read back from L2
  const float lse = lse_s;
  float* lk = log_new + (size_t)k * n;
  for (int i0 = t; i0 < n; i0 += U * THREADS) {
    float q[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int i = i0 + e * THREADS;
      q[e] = i < n ? __ldcg(lk + i) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int i = i0 + e * THREADS;
      if (i < n) lk[i] = __fsub_rn(q[e], lse);
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Dynamic shared memory of a packed block: its row ring (one stage per
// 32 / T rows, at most MAX_STAGES) and after it the row indices or dw of
// one chunk: all b rows up to CHUNK_ROWS, else CHUNK_ROWS at a time.  At
// most 64 KB + 128 KB (the static_assert above); the Python wrapper
// mirrors both (saddle_update.packed_ring_stages / packed_smem).
int ring_stages(int b, int tpb) {
  const int rows = STAGE_FLOATS / (tpb * LANE);
  const int stages = (b + rows - 1) / rows;
  return stages < MAX_STAGES ? stages : MAX_STAGES;
}

size_t packed_smem(int b, int nbuf) {
  const int chunk = b < CHUNK_ROWS ? b : CHUNK_ROWS;
  return (size_t)nbuf * STAGE_FLOATS * sizeof(float) +
         ((size_t)chunk * sizeof(float) + 15) / 16 * 16;
}

// Dynamic shared memory above 48 KB must be allowed per kernel and
// device; ``allowed`` keeps what each device allows so far.
int allow_smem(const void* kernel, size_t* allowed, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && allowed[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return (int)err;
}

bool valid_tpb(int tpb) {
  return tpb == 1 || tpb == 2 || tpb == 4 || tpb == 8;
}

// The grids of the launchers below, from their geometry arguments (also
// read by launch_geometry).
dim3 packed_grid(int n_pad, int tpb, int num_slots) {
  return dim3((n_pad / LANE + tpb - 1) / tpb, num_slots);
}

int dot_chunks(int b, int lpr) { return (b + 4 * lpr - 1) / (4 * lpr); }

dim3 dot_grid(int n, int b, int lpr, int pts, int num_clients) {
  return dim3((n + pts - 1) / pts, dot_chunks(b, lpr), num_clients);
}

dim3 mwu_grid(int n, int pts, int num_clients) {
  return dim3((n + pts - 1) / pts, num_clients);
}

size_t mwu_smem(int pts) { return 3 * (size_t)pts * sizeof(float); }

}  // namespace

// Static shared memory of kernel ``which`` (0 momentum_dot_packed, 1
// mwu_update_packed, 2-4 momentum_dot at B = 1 / float4 rows / other
// rows, 5-6 mwu_update with float4 rows / other rows) as compiled, for
// the audit's SMEM-001 bound.
extern "C" int static_smem(int which, int* bytes) {
  const void* kernels[] = {
      (const void*)momentum_dot_packed_kernel,
      (const void*)mwu_update_packed_kernel,
      (const void*)momentum_dot_kernel<true, false>,
      (const void*)momentum_dot_kernel<false, true>,
      (const void*)momentum_dot_kernel<false, false>,
      (const void*)mwu_update_kernel<true>,
      (const void*)mwu_update_kernel<false>};
  if (which < 0 || which >= (int)(sizeof(kernels) / sizeof(kernels[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err != cudaSuccess) return (int)err;
  *bytes = (int)attr.sharedSizeBytes;
  return 0;
}

// The grid (x, y, z) and dynamic shared memory, out[0..3], that launcher
// ``which`` (0 momentum_dot_packed_f32, 1 mwu_update_packed_f32, 2
// momentum_dot_f32, 3 mwu_update_f32) derives from its arguments: ``num``
// slots or clients of n points (n_pad for the packed ones), b rows or
// columns, g1 = tpb (packed) or lpr, g2 = pts.  The launch plans that
// analysis.kernel_audit checks are held equal to it on the card.
extern "C" int launch_geometry(int which, int num, int n, int b, int g1,
                               int g2, unsigned* out) {
  dim3 grid;
  size_t smem = 0;
  switch (which) {
    case 0:
    case 1:
      if (!valid_tpb(g1)) return (int)cudaErrorInvalidValue;
      grid = packed_grid(n, g1, num);
      smem = packed_smem(b, ring_stages(b, g1));
      break;
    case 2: grid = dot_grid(n, b, g1, g2, num); break;
    case 3:
      grid = mwu_grid(n, g2, num);
      smem = mwu_smem(g2);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = grid.x, out[1] = grid.y, out[2] = grid.z;
  out[3] = (unsigned)smem;
  return 0;
}

// delta (S, b); parts (S, n_pad / 128, b rounded up to 4) scratch,
// counters (S,) zero; tpb tiles per block (1, 2, 4 or 8).
extern "C" int momentum_dot_packed_f32(
    const float* x_t, const int* idx, const float* log_lam,
    const float* log_prev, const float* sign, const float* theta,
    float* out, float* parts, int* counters, int num_slots, int d,
    int n_pad, int b, int tpb, void* stream) {
  static size_t allowed[MAX_DEVICES];
  if (!valid_tpb(tpb)) return (int)cudaErrorInvalidValue;
  const int nbuf = ring_stages(b, tpb);
  const size_t smem = packed_smem(b, nbuf);
  if (b < 1 || b > d || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int err = allow_smem((const void*)momentum_dot_packed_kernel,
                             allowed, smem);
  if (err) return err;
  const dim3 grid = packed_grid(n_pad, tpb, num_slots);
  momentum_dot_packed_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x_t, idx, log_lam, log_prev, sign, theta, out, parts, counters, d,
      n_pad, b, tpb, nbuf);
  return (int)cudaGetLastError();
}

// log_new, u_new (S, n_pad); ms (2, S, 2) = (m, s); parts
// (S, n_pad / 128, 4) scratch, counters (S,) zero; tpb as above.
extern "C" int mwu_update_packed_f32(
    const float* x_t, const int* idx, const float* dw, const float* log_lam,
    const float* u, const float* sign, const float* mwu_c,
    const float* mwu_dot, float d_eff, float* log_new, float* u_new,
    float* ms, float* parts, int* counters, int num_slots, int d,
    int n_pad, int b, int tpb, void* stream) {
  static size_t allowed[MAX_DEVICES];
  if (!valid_tpb(tpb)) return (int)cudaErrorInvalidValue;
  const int nbuf = ring_stages(b, tpb);
  const size_t smem = packed_smem(b, nbuf);
  if (b < 1 || b > d || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int err = allow_smem((const void*)mwu_update_packed_kernel,
                             allowed, smem);
  if (err) return err;
  const dim3 grid = packed_grid(n_pad, tpb, num_slots);
  mwu_update_packed_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x_t, idx, dw, log_lam, u, sign, mwu_c, mwu_dot, d_eff, log_new, u_new,
      ms, parts, counters, d, n_pad, b, tpb, nbuf);
  return (int)cudaGetLastError();
}

// delta (K, b); chunks of 4 lpr columns; parts scratch of (K, chunks,
// point blocks, DOT_COLS) floats and counters (K, chunks) zero, both used
// only when a client has more than one point block; geometry (lpr, pts)
// as the wrapper's momentum_dot_geometry gives it; vec4: b % 4 == 0 and
// cols 16-byte aligned.
extern "C" int momentum_dot_f32(
    const float* cols, const float* log_lam, const float* log_prev,
    float theta, float* out, float* parts, int* counters, int num_clients,
    int n, int b, int lpr, int pts, int vec4, void* stream) {
  const int chunks = dot_chunks(b, lpr);
  if (n < 1 || b < 1 || pts < 1 || num_clients < 1 ||
      num_clients > 65535 || lpr < 1 || lpr > WARP || (lpr & (lpr - 1)) ||
      chunks > 65535 || (b == 1 && lpr != 1) ||
      (b > 1 && pts > DOT_POINTS) || (vec4 && b % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = dot_grid(n, b, lpr, pts, num_clients);
  const cudaStream_t st = (cudaStream_t)stream;
  if (b == 1)
    momentum_dot_kernel<true, false><<<grid, THREADS, 0, st>>>(
        cols, log_lam, log_prev, theta, out, parts, counters, n, b, lpr, pts);
  else if (vec4)
    momentum_dot_kernel<false, true><<<grid, THREADS, 0, st>>>(
        cols, log_lam, log_prev, theta, out, parts, counters, n, b, lpr, pts);
  else
    momentum_dot_kernel<false, false><<<grid, THREADS, 0, st>>>(
        cols, log_lam, log_prev, theta, out, parts, counters, n, b, lpr, pts);
  return (int)cudaGetLastError();
}

// log_new, u_new (K, n); ms (2, K) = (m, s); parts scratch of
// (K, point blocks, 2) floats and counters (K,) zero, both used only when
// a client has more than one point block; geometry (lpr, pts) as the
// wrapper's mwu_update_geometry gives it; vec4: b % 4 == 0 and cols
// 16-byte aligned.
extern "C" int mwu_update_f32(
    const float* cols, const float* log_lam, const float* u, const float* dw,
    float sign, float gamma, float tau, float d_eff, int normalize,
    float* log_new, float* u_new, float* ms, float* parts, int* counters,
    int num_clients, int n, int b, int lpr, int pts, int vec4,
    void* stream) {
  if (n < 1 || b < 1 || num_clients < 1 || num_clients > 65535 || pts < 1 ||
      pts > MWU_POINTS || lpr < 1 || lpr > WARP || (lpr & (lpr - 1)) ||
      (vec4 && b % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = mwu_grid(n, pts, num_clients);
  const size_t smem = mwu_smem(pts);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    mwu_update_kernel<true><<<grid, THREADS, smem, st>>>(
        cols, log_lam, u, dw, sign, gamma, tau, d_eff, normalize, log_new,
        u_new, ms, parts, counters, n, b, lpr, pts);
  else
    mwu_update_kernel<false><<<grid, THREADS, smem, st>>>(
        cols, log_lam, u, dw, sign, gamma, tau, d_eff, normalize, log_new,
        u_new, ms, parts, counters, n, b, lpr, pts);
  return (int)cudaGetLastError();
}
