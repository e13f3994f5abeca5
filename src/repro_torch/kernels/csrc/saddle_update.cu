// The kernels of the saddle step.
//
// PACKED (the production step, 2 launches per step): leading slot axis S,
// x_t (S, d, n_pad), idx (S, b), point vectors (S, n_pad) and per-slot
// scalars (S,).  Grid axes are (point tile, ..., slot).
//
// Replaces: src/repro/kernels/saddle_update.py,
//   _momentum_dot_packed_kernel (launched by _momentum_dot_packed_jit) and
//   _mwu_packed_kernel (launched by _mwu_update_packed_jit).
//
// What bounds them on an H100: bytes.  Each step reads b sampled rows of
// x_t (b * n_pad floats, gathered by index) plus a few point-length vectors,
// and does ~2 floating-point operations per byte-pair -- far below the
// card's compute rate.  The design therefore reads every byte once, in
// 16-byte coalesced loads:
//
//   * A point tile is LANE = 128 points, owned by one warp: each of the 32
//     threads holds 4 consecutive points as one float4.  n_pad is a
//     multiple of 128 (the wrapper checks), so tiles never straddle the
//     edge and no lane is masked.
//   * The Pallas kernels walk the b sampled rows as a sequential grid axis
//     and carry the signed momentum / dv in VMEM scratch.  Blocks here run
//     in no order, so the walk over rows is a loop inside the block and the
//     carried values live in registers.  The block reads idx itself (the
//     Pallas kernels scalar-prefetch it).
//   * Reductions across tiles are written as per-tile partials --
//     (S, tiles, b) for the dot, (S, tiles, 4) for the MWU normalizers --
//     and combined by the caller in a fixed order, as the JAX wrapper does
//     outside its pallas_call.  No float atomics: the result is the same
//     bits on every run.
//   * momentum_dot_packed additionally splits the b rows over grid axis 1
//     (ROWS_PER_BLOCK rows a block) so b = 128 puts ~8x more loads in
//     flight; each block recomputes its tile's momentum (3 short reads,
//     mostly from L2).
//
// Padding lanes carry sign 0 and log weight -1e30, whose expf is exactly 0.
// Per-class max / sum-exp partials are masked by sign, so a tile with no
// point of a class gives (NEG, 0) for it -- never (NEG, inf).
//
// A sampled row index outside [0, d) is never read: the load goes to row 0
// instead and the dot of that row, or the whole dv, becomes NaN, so the
// caller's outputs are NaN (the solver's health flags then stop the slot)
// instead of an illegal memory access that would poison the CUDA context.
// The load itself stays unconditional, so the unrolled row loop keeps
// several loads in flight.
//
// UNPACKED (the per-class reference step, 4 launches per step): cols
// (K, n, B) row-major -- the step's B sampled coordinates of each of a
// client's n points, gathered by the caller -- point vectors (K, n), with
// K clients (K = 1 serially).  Grid (point tile, client).  The wrapper
// picks the tile by B (at most TILE = 1024 points, the Pallas tile) so a
// thread handles ~8 points and a wide B still gives many blocks; any n is
// taken: the last tile is masked in the kernel (its missing points touch
// no sum, max or store), where the JAX wrapper pads with a copy at log
// weight -1e30.
//
// Replaces: src/repro/kernels/saddle_update.py,
//   _momentum_dot_kernel (launched by _momentum_dot_jit) and
//   _mwu_kernel (launched by _mwu_update_jit).
//
// Bound on an H100: bytes again (cols is read once, ~2 flops a float).
//   * momentum_dot: the block computes its points' momentum once into
//     shared memory, then reduces cols[i, j] * mom_i over the tile.  Threads
//     map to (column j, point phase p) so that neighbouring threads read
//     neighbouring floats of the contiguous (tile, B) block for any B <= 256
//     (B = 1: 256 phases over the points; B = 128: 2 phases); the phases
//     are summed by a tree in shared memory into per-tile partials
//     (K, tiles, B) that the wrapper sums in a fixed order.
//   * mwu_update: dv_i = cols[i] . dw first, a warp per row when B >= 32
//     (coalesced row reads, shuffle sum) and a thread per row below; then
//     v, log_new and u_new per point, and the tile's max and sum of
//     exp(log_new - max) reduced in the block into partials (K, tiles)
//     that the wrapper merges into the per-client logsumexp.
//   * The step scalars arrive as floats; c = 1 / (gamma + d_eff / tau) is
//     computed in float32 inside, as the Pallas kernel does, and the
//     elementwise arithmetic is rounded op by op (__fmul_rn / __fadd_rn,
//     no fused multiply-add) so the plain version repeats it exactly.
//   * Round-robin padding points of a client shard carry log weight -1e30
//     and zero rows: exp gives 0 momentum, and c * (d_eff / tau) <= 1 keeps
//     their log_new finite near -1e30, so they add exactly 0 to the sums.

#include <cuda_runtime.h>

namespace {

constexpr int LANE = 128;           // points per tile (one warp x float4)
constexpr int WARP = 32;
constexpr int ROWS_PER_BLOCK = 16;  // sampled rows per momentum-dot block
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

__device__ __forceinline__ float momentum(float lg, float lg_prev, float sg,
                                          float theta) {
  const float lam = expf(lg);
  const float lam_prev = expf(lg_prev);
  return sg * (lam + theta * (lam - lam_prev));
}

// parts[s, tile, j] = sum over the tile's points i of
//   sign_i (lam_i + theta (lam_i - lam_prev_i)) x_t[s, idx[s, j], i]
__global__ void momentum_dot_packed_kernel(
    const float* __restrict__ x_t, const int* __restrict__ idx,
    const float* __restrict__ log_lam, const float* __restrict__ log_prev,
    const float* __restrict__ sign, const float* __restrict__ theta,
    float* __restrict__ parts, int d, int n_pad, int b) {
  const int tile = blockIdx.x;
  const int j0 = blockIdx.y * ROWS_PER_BLOCK;
  const int s = blockIdx.z;
  const int tiles = gridDim.x;
  const int lane = threadIdx.x;

  const size_t pt = (size_t)s * n_pad + (size_t)tile * LANE + lane * 4;
  const float th = theta[s];
  const float4 lg = load4(log_lam + pt);
  const float4 lp = load4(log_prev + pt);
  const float4 sg = load4(sign + pt);
  float4 mom;
  mom.x = momentum(lg.x, lp.x, sg.x, th);
  mom.y = momentum(lg.y, lp.y, sg.y, th);
  mom.z = momentum(lg.z, lp.z, sg.z, th);
  mom.w = momentum(lg.w, lp.w, sg.w, th);

  const float* xs = x_t + (size_t)s * d * n_pad + (size_t)tile * LANE +
                    lane * 4;
  const int* ids = idx + (size_t)s * b;
  float* out = parts + ((size_t)s * tiles + tile) * b;
  const int j1 = min(b, j0 + ROWS_PER_BLOCK);
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const int row = ids[j];
    const bool ok = (unsigned)row < (unsigned)d;
    const float4 xv = load4(xs + (size_t)(ok ? row : 0) * n_pad);
    float acc = xv.x * mom.x + xv.y * mom.y + xv.z * mom.z + xv.w * mom.w;
    acc = warp_sum(ok ? acc : nan_f32());
    if (lane == 0) out[j] = acc;
  }
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
// parts[s, tile] = (m_p, s_p, m_m, s_m), the tile's per-class normalizers.
__global__ void mwu_update_packed_kernel(
    const float* __restrict__ x_t, const int* __restrict__ idx,
    const float* __restrict__ dw, const float* __restrict__ log_lam,
    const float* __restrict__ u, const float* __restrict__ sign,
    const float* __restrict__ mwu_c, const float* __restrict__ mwu_dot,
    float d_eff, float* __restrict__ log_new, float* __restrict__ u_new,
    float* __restrict__ parts, int d, int n_pad, int b) {
  const int tile = blockIdx.x;
  const int s = blockIdx.y;
  const int tiles = gridDim.x;
  const int lane = threadIdx.x;

  const float* xs = x_t + (size_t)s * d * n_pad + (size_t)tile * LANE +
                    lane * 4;
  const int* ids = idx + (size_t)s * b;
  const float* dws = dw + (size_t)s * b;
  float4 dv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool ok = true;
#pragma unroll 4
  for (int j = 0; j < b; ++j) {
    const int row = ids[j];
    const bool in_range = (unsigned)row < (unsigned)d;
    ok = ok && in_range;
    const float4 xv = load4(xs + (size_t)(in_range ? row : 0) * n_pad);
    const float w = dws[j];
    dv.x += xv.x * w;
    dv.y += xv.y * w;
    dv.z += xv.z * w;
    dv.w += xv.w * w;
  }
  if (!ok) {
    const float nan = nan_f32();
    dv = make_float4(nan, nan, nan, nan);
  }

  const size_t pt = (size_t)s * n_pad + (size_t)tile * LANE + lane * 4;
  const float c = mwu_c[s];
  const float dot = mwu_dot[s];
  const float4 sg = load4(sign + pt);
  const float4 uu = load4(u + pt);
  const float4 lg = load4(log_lam + pt);
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
  if (lane == 0) {
    float* out = parts + ((size_t)s * tiles + tile) * 4;
    out[0] = mp;
    out[1] = sp;
    out[2] = mm;
    out[3] = sm;
  }
}

constexpr int TILE = 1024;          // most points per unpacked-kernel block
constexpr int THREADS = 256;        // threads per unpacked-kernel block
constexpr int WARPS = THREADS / WARP;

__device__ __forceinline__ float neg_inf_f32() {
  return __int_as_float(0xff800000);
}

// parts[k, tile, j] = sum over the tile's points i of
//   cols[k, i, j] * (lam_i + theta (lam_i - lam_prev_i))
__global__ void momentum_dot_kernel(
    const float* __restrict__ cols, const float* __restrict__ log_lam,
    const float* __restrict__ log_prev, float theta,
    float* __restrict__ parts, int n, int b, int tile_n) {
  __shared__ float mom[TILE];
  __shared__ float red[THREADS];
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int tiles = gridDim.x;
  const int t = threadIdx.x;
  const int i0 = tile * tile_n;
  const int tn = min(tile_n, n - i0);        // points in this tile

  const float* lg = log_lam + (size_t)k * n + i0;
  const float* lp = log_prev + (size_t)k * n + i0;
  for (int i = t; i < tn; i += THREADS) {
    const float lam = expf(lg[i]);
    const float lam_prev = expf(lp[i]);
    mom[i] = __fadd_rn(lam, __fmul_rn(theta, __fsub_rn(lam, lam_prev)));
  }
  __syncthreads();

  const float* c = cols + ((size_t)k * n + i0) * b;
  float* out = parts + ((size_t)k * tiles + tile) * b;
  for (int j0 = 0; j0 < b; j0 += THREADS) {
    const int wc = min(THREADS, b - j0);     // columns of this chunk
    const int phases = THREADS / wc;         // point phases per column
    const int j = t % wc;
    const int p = t / wc;
    float acc = 0.0f;
    if (p < phases) {
      for (int i = p; i < tn; i += phases)
        acc = __fadd_rn(acc, __fmul_rn(c[(size_t)i * b + j0 + j], mom[i]));
    }
    red[t] = acc;
    __syncthreads();
    // tree over the phases, for any phase count: phase q < live - half
    // adds phase q + half
    for (int live = phases; live > 1;) {
      const int half = (live + 1) / 2;
      if (p < live - half) red[t] += red[t + half * wc];
      __syncthreads();
      live = half;
    }
    if (t < wc) out[j0 + t] = red[t];
    __syncthreads();
  }
}

// dv_i = cols[k, i, :] . dw[k, :];  v = sign (u + d_eff dv);
// log_new = c ((d_eff / tau) log_lam - v), c = 1 / (gamma + d_eff / tau);
// u_new = u + dv;  pmax[k, tile], psum[k, tile] = the tile's max of log_new
// and sum of exp(log_new - max).
__global__ void mwu_update_kernel(
    const float* __restrict__ cols, const float* __restrict__ log_lam,
    const float* __restrict__ u, const float* __restrict__ dw, float sign,
    float gamma, float tau, float d_eff, float* __restrict__ log_new,
    float* __restrict__ u_new, float* __restrict__ pmax,
    float* __restrict__ psum, int n, int b, int tile_n) {
  __shared__ float val[TILE];                // dv, then log_new
  __shared__ float red[WARPS];
  __shared__ float bcast;
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int tiles = gridDim.x;
  const int t = threadIdx.x;
  const int lane = t % WARP;
  const int warp = t / WARP;
  const int i0 = tile * tile_n;
  const int tn = min(tile_n, n - i0);

  const float* c = cols + ((size_t)k * n + i0) * b;
  const float* dwk = dw + (size_t)k * b;
  if (b >= WARP) {
    for (int i = warp; i < tn; i += WARPS) {
      const float* row = c + (size_t)i * b;
      float acc = 0.0f;
      for (int j = lane; j < b; j += WARP)
        acc = __fadd_rn(acc, __fmul_rn(row[j], dwk[j]));
      acc = warp_sum(acc);
      if (lane == 0) val[i] = acc;
    }
  } else {
    for (int i = t; i < tn; i += THREADS) {
      const float* row = c + (size_t)i * b;
      float acc = 0.0f;
      for (int j = 0; j < b; ++j)
        acc = __fadd_rn(acc, __fmul_rn(row[j], dwk[j]));
      val[i] = acc;
    }
  }
  __syncthreads();

  const float ratio = __fdiv_rn(d_eff, tau);
  const float cc = __fdiv_rn(1.0f, __fadd_rn(gamma, ratio));
  const size_t base = (size_t)k * n + i0;
  float mx = neg_inf_f32();
  for (int i = t; i < tn; i += THREADS) {
    const float dv = val[i];
    const float uu = u[base + i];
    const float v = __fmul_rn(sign, __fadd_rn(uu, __fmul_rn(d_eff, dv)));
    const float ln = __fmul_rn(cc, __fsub_rn(__fmul_rn(ratio,
                                                       log_lam[base + i]),
                                             v));
    log_new[base + i] = ln;
    u_new[base + i] = __fadd_rn(uu, dv);
    val[i] = ln;
    mx = fmaxf(mx, ln);
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (t == 0) {
    float m = red[0];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
    bcast = m;
  }
  __syncthreads();
  const float m = bcast;
  float sm = 0.0f;
  for (int i = t; i < tn; i += THREADS) sm += expf(val[i] - m);
  sm = warp_sum(sm);
  __syncthreads();                           // red[] was read by thread 0
  if (lane == 0) red[warp] = sm;
  __syncthreads();
  if (t == 0) {
    float s = red[0];
    for (int w = 1; w < WARPS; ++w) s += red[w];
    pmax[(size_t)k * tiles + tile] = m;
    psum[(size_t)k * tiles + tile] = s;
  }
}

}  // namespace

extern "C" int momentum_dot_packed_f32(
    const float* x_t, const int* idx, const float* log_lam,
    const float* log_prev, const float* sign, const float* theta,
    float* parts, int num_slots, int d, int n_pad, int b, void* stream) {
  const dim3 grid(n_pad / LANE, (b + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                  num_slots);
  momentum_dot_packed_kernel<<<grid, WARP, 0, (cudaStream_t)stream>>>(
      x_t, idx, log_lam, log_prev, sign, theta, parts, d, n_pad, b);
  return (int)cudaGetLastError();
}

extern "C" int mwu_update_packed_f32(
    const float* x_t, const int* idx, const float* dw, const float* log_lam,
    const float* u, const float* sign, const float* mwu_c,
    const float* mwu_dot, float d_eff, float* log_new, float* u_new,
    float* parts, int num_slots, int d, int n_pad, int b, void* stream) {
  const dim3 grid(n_pad / LANE, num_slots);
  mwu_update_packed_kernel<<<grid, WARP, 0, (cudaStream_t)stream>>>(
      x_t, idx, dw, log_lam, u, sign, mwu_c, mwu_dot, d_eff, log_new, u_new,
      parts, d, n_pad, b);
  return (int)cudaGetLastError();
}

extern "C" int momentum_dot_f32(
    const float* cols, const float* log_lam, const float* log_prev,
    float theta, float* parts, int num_clients, int n, int b, int tile_n,
    void* stream) {
  if (tile_n < 1 || tile_n > TILE) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + tile_n - 1) / tile_n, num_clients);
  momentum_dot_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cols, log_lam, log_prev, theta, parts, n, b, tile_n);
  return (int)cudaGetLastError();
}

extern "C" int mwu_update_f32(
    const float* cols, const float* log_lam, const float* u, const float* dw,
    float sign, float gamma, float tau, float d_eff, float* log_new,
    float* u_new, float* pmax, float* psum, int num_clients, int n, int b,
    int tile_n, void* stream) {
  if (tile_n < 1 || tile_n > TILE) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + tile_n - 1) / tile_n, num_clients);
  mwu_update_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cols, log_lam, u, dw, sign, gamma, tau, d_eff, log_new, u_new, pmax,
      psum, n, b, tile_n);
  return (int)cudaGetLastError();
}
