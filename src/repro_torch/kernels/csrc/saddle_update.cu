// The two per-iteration kernels of the packed saddle step, with a leading
// slot axis S: x_t (S, d, n_pad), idx (S, b), point vectors (S, n_pad) and
// per-slot scalars (S,).  Grid axes are (point tile, ..., slot).
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
