// Building blocks shared by the fused block kernels: MYULA (myula_block.cu),
// ULPDA (ulpda_block.cu) and the wavelet blocks (wavelet_block.cu).
//
// Launch level, one thread per pixel of a row-major (ny, nx) float32 field,
// every field in global memory (at 512^2 a block's working set stays in the
// 50 MB L2), each kernel bound by device-memory bytes and, at 512^2, by launch
// latency: the separable wrap-convolution passes of A^T A, the Chambolle and
// FGP dual trips of the TV prox and the host loop that launches them, and the
// MC-TV gradient clamp.
//
// Device level: the per-pixel P^2 quantile update, the burn-in-masked Welford
// update and its per-step bookkeeping, and the interleaved multi-level Haar
// transform on a region of the image held in one CTA's shared memory.
#pragma once

#include "tv_common.cuh"

#define LMC_MAXR 4
#define LMC_MAXK 32
#define LMC_MAXQ 4
// A CTA of the tile kernels owns a region of at most LMC_TILE_SIDE^2 pixels,
// LMC_TILE_PPT of them per thread (wavelet_fused.py: _TILE_SIDE).
#define LMC_TILE_SIDE 32
#define LMC_TILE_THREADS 256
#define LMC_TILE_PPT (LMC_TILE_SIDE * LMC_TILE_SIDE / LMC_TILE_THREADS)

namespace {

// Data-term modes of the block kernels (myula_fused.py: MODES).
enum { MODE_TV = 0, MODE_MCTV = 1, MODE_METV = 2 };

// Elementwise sort of 5 values (myula_fused.py::_sort5's network).
__device__ __forceinline__ void sort5(float v[5]) {
  const int pairs[9][2] = {{0, 1}, {3, 4}, {2, 4}, {2, 3}, {0, 3},
                           {0, 2}, {1, 4}, {1, 3}, {1, 2}};
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const int a = pairs[e][0], b = pairs[e][1];
    const float lo = fminf(v[a], v[b]);
    const float hi = fmaxf(v[a], v[b]);
    v[a] = lo;
    v[b] = hi;
  }
}

// One recorded P^2 observation (myula_fused.py::_p2_update) for one pixel:
// q holds the 5 marker heights, n the 3 interior positions; c_prev
// observations were absorbed before this one; coef[m] = (dn[m+1] - 1) / 4.
// Every array index is a constant after unrolling, so a caller's markers can
// stay in registers.
__device__ __forceinline__ void p2_update(float x, float q[5], float n3[3],
                                          int c_prev, const float coef[3]) {
  if (c_prev < 5) {
#pragma unroll
    for (int m = 0; m < 5; ++m)
      if (m == c_prev) q[m] = x;
    if (c_prev == 4) sort5(q);
    return;
  }
  q[0] = fminf(q[0], x);
  q[4] = fmaxf(q[4], x);
  const float k = (float)(x >= q[1]) + (float)(x >= q[2]) + (float)(x >= q[3]);
  const float cnt = (float)(c_prev + 1);
  float n[5] = {1.0f, n3[0] + (float)(1.0f > k), n3[1] + (float)(2.0f > k),
                n3[2] + (float)(3.0f > k), cnt};
#pragma unroll
  for (int m = 1; m <= 3; ++m) {
    const float nprime = 1.0f + coef[m - 1] * (cnt - 1.0f);
    const float d = nprime - n[m];
    const bool up = (d >= 1.0f) && (n[m + 1] - n[m] > 1.0f);
    const bool dn = (d <= -1.0f) && (n[m - 1] - n[m] < -1.0f);
    const float s = up ? 1.0f : (dn ? -1.0f : 0.0f);
    if (s == 0.0f) continue;
    const float nm = n[m - 1], ni = n[m], np = n[m + 1];
    const float qm = q[m - 1], qi = q[m], qp = q[m + 1];
    const float d_t = (np - nm != 0.0f) ? np - nm : 1.0f;
    const float d_u = (np - ni != 0.0f) ? np - ni : 1.0f;
    const float d_l = (ni - nm != 0.0f) ? ni - nm : 1.0f;
    const float para = qi + s / d_t *
                                ((ni - nm + s) * (qp - qi) / d_u +
                                 (np - ni - s) * (qi - qm) / d_l);
    const bool ok = (qm < para) && (para < qp);
    const float lin = qi + s * ((s > 0.0f) ? (qp - qi) / d_u : (qi - qm) / d_l);
    q[m] = ok ? para : lin;
    n[m] = ni + s;
  }
  n3[0] = n[1];
  n3[1] = n[2];
  n3[2] = n[3];
}

// The per-step bookkeeping of the block kernels that compute it on the card
// (the wavelet blocks; kernel 2 and 3 compute the same on the host).
struct Sched {
  long long step0, burn, cnt0;  // first global step, burn-in, Welford count in
  int thin, n_q, with_noise, with_stats;
  uint32_t seed, chain;
  // the chain words of a launch's grid layers (device, one a layer), or null
  // for a one-chain launch, whose word is chain (lmc_sched_chain); kernels 2
  // and 3 take theirs as an argument and leave this null
  const uint32_t* chains;
  float qcoef[LMC_MAXQ][3];
};

// The Philox chain word of grid layer blockIdx.z.
__device__ __forceinline__ uint32_t lmc_sched_chain(const Sched& sc) {
  return sc.chains ? sc.chains[blockIdx.z] : sc.chain;
}

struct StepW {
  float w, inv_denom;  // Welford weight (0 or 1) and 1 / count
  int record, c_prev;  // a P^2 observation at this step; observations before
};

// Global step g: the weighted Welford count cnt0 + steps of this call at or
// past burn-in, and the global P^2 observation count (see
// myula_fused.py::myula_tv_block_update_ref). 1 / n is the float reciprocal,
// as torch divides a CUDA tensor by a Python scalar.
__device__ __forceinline__ StepW lmc_step_w(const Sched& sc, long long g) {
  StepW o;
  o.w = g >= sc.burn ? 1.0f : 0.0f;
  const long long lo = sc.burn > sc.step0 ? sc.burn : sc.step0;
  const long long n_new = sc.cnt0 + (g + 1 - lo > 0 ? g + 1 - lo : 0);
  o.inv_denom = 1.0f / (float)(n_new > 1 ? n_new : 1);
  o.record = sc.n_q > 0 && g >= sc.burn && (g + 1) % sc.thin == 0;
  const long long c_prev = g / sc.thin - sc.burn / sc.thin;
  o.c_prev = (int)(c_prev > 0 ? c_prev : 0);
  return o;
}

// Burn-in-masked Welford update of one pixel: delta / n as delta * (1 / n).
__device__ __forceinline__ void lmc_welford(float xn, float* mu, float* m2,
                                            const StepW& sw) {
  const float delta = xn - *mu;
  const float mu_new = *mu + sw.w * delta * sw.inv_denom;
  *m2 = *m2 + sw.w * delta * (xn - mu_new);
  *mu = mu_new;
}

// P^2 of pixel k with the markers in global memory, on a recorded step.
__device__ __forceinline__ void lmc_p2_global(float xn, size_t k, size_t npix,
                                              float* __restrict__ qh,
                                              float* __restrict__ qn,
                                              const Sched& sc,
                                              const StepW& sw) {
  if (!sw.record) return;
  for (int jq = 0; jq < sc.n_q; ++jq) {
    float q[5], n3[3];
#pragma unroll
    for (int m = 0; m < 5; ++m) q[m] = qh[(5 * jq + m) * npix + k];
#pragma unroll
    for (int m = 0; m < 3; ++m) n3[m] = qn[(3 * jq + m) * npix + k];
    p2_update(xn, q, n3, sw.c_prev, sc.qcoef[jq]);
#pragma unroll
    for (int m = 0; m < 5; ++m) qh[(5 * jq + m) * npix + k] = q[m];
#pragma unroll
    for (int m = 0; m < 3; ++m) qn[(3 * jq + m) * npix + k] = n3[m];
  }
}

// Welford and P^2 of pixel k with the statistics in global memory.
__device__ __forceinline__ void lmc_record_global(
    float xn, size_t k, size_t npix, float* __restrict__ mean,
    float* __restrict__ m2, float* __restrict__ qh, float* __restrict__ qn,
    const Sched& sc, const StepW& sw) {
  if (sc.with_stats) {
    float mu = mean[k], mm = m2[k];
    lmc_welford(xn, &mu, &mm, sw);
    mean[k] = mu;
    m2[k] = mm;
  }
  lmc_p2_global(xn, k, npix, qh, qn, sc, sw);
}

// --- the interleaved Haar transform on a region in shared memory -----------
// wavelet_fused.py::haar_interleaved: at level l (stride s = 2^l) a butterfly
// along each axis pairs slot p (index % 2s == 0) with q = p + s on the lattice
// where the other index % s == 0. Pairs never leave an aligned 2^levels
// square, so a region whose sides are multiples of 2^levels and that starts on
// such a multiple transforms on its own. buf holds the region row-major, rh x
// rw <= LMC_TILE_SIDE^2; every thread of the CTA takes part.

#define LMC_SQRT1_2 0.70710678118654757f

// One butterfly pass: (a, b) -> ((a + b) / sqrt2, (a - b) / sqrt2), each as a
// multiply by the float 1/sqrt2 (wavelet_fused.py::_haar_pass); ends with a
// barrier.
__device__ __forceinline__ void lmc_haar_pass(float* buf, int rh, int rw,
                                              int s, int axis) {
  const int nr = axis == 0 ? rh / (2 * s) : rh / s;
  const int nc = axis == 0 ? rw / s : rw / (2 * s);
  for (int t = threadIdx.x; t < nr * nc; t += blockDim.x) {
    const int r = (t / nc) * (axis == 0 ? 2 * s : s);
    const int c = (t % nc) * (axis == 0 ? s : 2 * s);
    const int p = r * rw + c;
    const int q = axis == 0 ? p + s * rw : p + s;
    const float a = buf[p], b = buf[q];
    buf[p] = (a + b) * LMC_SQRT1_2;
    buf[q] = (a - b) * LMC_SQRT1_2;
  }
  __syncthreads();
}

// Forward transform of levels levels (per level: rows, then columns).
__device__ __forceinline__ void lmc_haar_fwd(float* buf, int rh, int rw,
                                             int levels) {
  for (int lv = 0; lv < levels; ++lv) {
    lmc_haar_pass(buf, rh, rw, 1 << lv, 0);
    lmc_haar_pass(buf, rh, rw, 1 << lv, 1);
  }
}

// Inverse (transpose) transform: the levels in reverse, columns then rows.
__device__ __forceinline__ void lmc_haar_inv(float* buf, int rh, int rw,
                                             int levels) {
  for (int lv = levels - 1; lv >= 0; --lv) {
    lmc_haar_pass(buf, rh, rw, 1 << lv, 1);
    lmc_haar_pass(buf, rh, rw, 1 << lv, 0);
  }
}

// Pixel k of region-linear index li of the CTA's region (blockIdx.x over
// column regions, blockIdx.y over row regions), or -1 past the region.
__device__ __forceinline__ int lmc_region_pixel(int li, int rh, int rw,
                                                int nx) {
  if (li >= rh * rw) return -1;
  return (blockIdx.y * rh + li / rw) * nx + blockIdx.x * rw + li % rw;
}

// Host side: whether (rh, rw) is a valid region for levels levels of an
// (ny, nx) image.
static inline bool lmc_region_ok(int ny, int nx, int rh, int rw, int levels) {
  const int t = 1 << levels;
  return levels >= 0 && rh >= t && rw >= t && rh <= LMC_TILE_SIDE &&
         rw <= LMC_TILE_SIDE && rh % t == 0 && rw % t == 0 && ny % rh == 0 &&
         nx % rw == 0;
}

// A^T A = sum_r wy_r wx_r^T as separable taps, offsets (oy, ox).
struct Taps {
  int rank, ky, kx, oy, ox;
  float wy[LMC_MAXR][LMC_MAXK];
  float wx[LMC_MAXR][LMC_MAXK];
};

// Taps from the host layout: rank * (ky + kx) floats, for each rank wy then wx.
// Returns false on a shape outside LMC_MAXR / LMC_MAXK.
static inline bool lmc_taps(Taps* t, const float* taps, int rank, int ky,
                            int kx, int oy, int ox) {
  if (rank < 1 || rank > LMC_MAXR || ky < 1 || kx < 1 || ky > LMC_MAXK ||
      kx > LMC_MAXK)
    return false;
  t->rank = rank;
  t->ky = ky;
  t->kx = kx;
  t->oy = oy;
  t->ox = ox;
  for (int r = 0; r < rank; ++r) {
    const float* base = taps + (size_t)r * (ky + kx);
    for (int a = 0; a < ky; ++a) t->wy[r][a] = base[a];
    for (int b = 0; b < kx; ++b) t->wx[r][b] = base[ky + b];
  }
  return true;
}

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// Pixel (i, j) after one interleaved Haar butterfly pass at stride s > 0
// along axis over a whole (ny, nx) image in global memory, the per-level
// form of lmc_haar_pass (wavelet_fused.py::_haar_pass): on the lattice where
// the other index % s == 0, slot idx % 2s == 0 of a pair (a, b) = (in[idx],
// in[idx + s]) takes (a + b) * (1/sqrt2) and slot s takes (a - b) * (1/sqrt2);
// every other pixel copies through. The butterfly is an involution, so
// forward and inverse passes alike; pairs wrap around the image.
__device__ __forceinline__ float lmc_haar_point(const float* __restrict__ in,
                                                int ny, int nx, int i, int j,
                                                int s, int axis) {
  const float v = in[(size_t)i * nx + j];
  const int idx = axis == 0 ? i : j;
  const int other = axis == 0 ? j : i;
  const int r = idx & (2 * s - 1);
  if ((other & (s - 1)) != 0 || (r != 0 && r != s)) return v;
  const int t = wrap(idx + (r == 0 ? s : -s), axis == 0 ? ny : nx);
  const float w = axis == 0 ? in[(size_t)t * nx + j] : in[(size_t)i * nx + t];
  return r == 0 ? (v + w) * LMC_SQRT1_2 : (w - v) * LMC_SQRT1_2;
}

// tmp[r, i, j] = sum_b wx_r[b] x[i, (j - b + ox) mod nx] (each grid layer a
// chain, tmp plane-major: lmc_chain_at)
__global__ void blk_rowconv(const float* __restrict__ x, float* __restrict__ tmp,
                            int ny, int nx, Taps t) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const float* row = lmc_chain_at(x, ny, nx) + (size_t)i * nx;
  tmp = lmc_chain_at(tmp, ny, nx);
  const size_t plane = (size_t)gridDim.z * ny * nx;
  for (int r = 0; r < t.rank; ++r) {
    float acc = 0.0f;
    bool first = true;
    for (int b = 0; b < t.kx; ++b) {
      const float w = t.wx[r][b];
      if (w == 0.0f) continue;
      const float term = row[wrap(j - b + t.ox, nx)] * w;
      acc = first ? term : acc + term;
      first = false;
    }
    tmp[(size_t)r * plane + (size_t)i * nx + j] = acc;
  }
}

// out[i, j] = sum_r sum_a wy_r[a] tmp[r, (i - a + oy) mod ny, j], written as
// sigma * out - atbs[i, j] (the MYULA data gradient) or, with a null atbs,
// as A^T A x itself (the ULPDA gram apply); the chains share atbs.
__global__ void blk_colconv(const float* __restrict__ tmp,
                            const float* __restrict__ atbs,
                            float* __restrict__ out, int ny, int nx, Taps t,
                            float sigma) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  tmp = lmc_chain_at(tmp, ny, nx);
  out = lmc_chain_at(out, ny, nx);
  float sum = 0.0f;
  for (int r = 0; r < t.rank; ++r) {
    const float* plane = tmp + (size_t)r * gridDim.z * ny * nx;
    float acc = 0.0f;
    bool first = true;
    for (int a = 0; a < t.ky; ++a) {
      const float w = t.wy[r][a];
      if (w == 0.0f) continue;
      const float term = plane[(size_t)wrap(i - a + t.oy, ny) * nx + j] * w;
      acc = first ? term : acc + term;
      first = false;
    }
    sum = (r == 0) ? acc : sum + acc;
  }
  const int k = i * nx + j;
  out[k] = atbs ? sigma * sum - atbs[k] : sum;
}

__global__ void blk_chambolle_trip(const float* __restrict__ x,
                                   const float* __restrict__ py,
                                   const float* __restrict__ px,
                                   float* __restrict__ qy,
                                   float* __restrict__ qx, int ny, int nx,
                                   float inv_gamma, float step) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  lmc_chambolle_point(lmc_chain_at(x, ny, nx), lmc_chain_at(py, ny, nx),
                      lmc_chain_at(px, ny, nx), lmc_chain_at(qy, ny, nx),
                      lmc_chain_at(qx, ny, nx), inv_gamma, step, i, j, ny, nx);
}

// One FGP trip (myula_fused.py::_tv_prox_fgp): q = proj(r + s grad u(r)),
// r' = q + c (q - p); r and p may alias (the first trip), q and r' may not.
__global__ void blk_fgp_trip(const float* __restrict__ x, const float* ry,
                             const float* rx, const float* py, const float* px,
                             float* __restrict__ qy, float* __restrict__ qx,
                             float* __restrict__ sy, float* __restrict__ sx,
                             int ny, int nx, float inv_gamma, float step,
                             float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  x = lmc_chain_at(x, ny, nx);
  ry = lmc_chain_at(ry, ny, nx);
  rx = lmc_chain_at(rx, ny, nx);
  py = lmc_chain_at(py, ny, nx);
  px = lmc_chain_at(px, ny, nx);
  qy = lmc_chain_at(qy, ny, nx);
  qx = lmc_chain_at(qx, ny, nx);
  sy = lmc_chain_at(sy, ny, nx);
  sx = lmc_chain_at(sx, ny, nx);
  float gy, gx;
  lmc_grad_u(x, ry, rx, inv_gamma, i, j, ny, nx, &gy, &gx);
  const int k = i * nx + j;
  const float ty = (ry ? ry[k] : 0.0f) + step * gy;
  const float tx = (rx ? rx[k] : 0.0f) + step * gx;
  const float scale = fminf(1.0f, rsqrtf(ty * ty + tx * tx));
  const float ay = ty * scale;
  const float ax = tx * scale;
  const float py0 = py ? py[k] : 0.0f;
  const float px0 = px ? px[k] : 0.0f;
  qy[k] = ay;
  qx[k] = ax;
  sy[k] = ay + c * (ay - py0);
  sx[k] = ax + c * (ax - px0);
}

// The MC-TV clamp of ncvx_tv.py::_grad_moreau (isotropic, op2 = Gradient2D):
// (cy, cx) = min(1/gamma, 1/|grad f|) grad f, |grad f| = 1e-9 where it is 0.
__global__ void blk_mctv_clamp(const float* __restrict__ f,
                               float* __restrict__ cy, float* __restrict__ cx,
                               int ny, int nx, float inv_gamma_mc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  f = lmc_chain_at(f, ny, nx);
  cy = lmc_chain_at(cy, ny, nx);
  cx = lmc_chain_at(cx, ny, nx);
  const int k = i * nx + j;
  const float gy = (i < ny - 1) ? f[k + nx] - f[k] : 0.0f;
  const float gx = (j < nx - 1) ? f[k + 1] - f[k] : 0.0f;
  float mag = sqrtf(gy * gy + gx * gx);
  mag = (mag != 0.0f) ? mag : 1e-9f;
  const float clamp = fminf(1.0f / mag, inv_gamma_mc);
  cy[k] = clamp * gy;
  cx[k] = clamp * gx;
}

// Dual buffers of one TV prox: P[0], P[1] hold the iterate p, R[0], R[1] the
// FGP point r, each a (y, x) pair of planes carved from 8 planes at base.
struct DualBufs {
  float* P[2][2];
  float* R[2][2];
};

static inline DualBufs lmc_dual_bufs(float* base, size_t npix) {
  DualBufs b;
  for (int s = 0; s < 2; ++s)
    for (int c = 0; c < 2; ++c) {
      b.P[s][c] = base + (size_t)(2 * s + c) * npix;
      b.R[s][c] = base + (size_t)(4 + 2 * s + c) * npix;
    }
  return b;
}

// niter dual trips of the TV prox of f at 1/gamma = inv_gamma, Chambolle at
// step tv_step or FGP at step 1/8 with momentum fgp_coef, starting from the
// dual P[pin] (pin = -1: the zero field), for nc chains (one grid layer
// each; b's planes carved at nc ny nx floats). Returns the index into P of
// the final dual (-1 when niter is 0 and the start was the zero field).
static inline int lmc_tv_trips(const float* f, const DualBufs& b, int pin,
                               int niter, bool fgp, float tv_step,
                               const float* fgp_coef, float inv_gamma,
                               int ny, int nx, cudaStream_t s, int nc = 1) {
  const dim3 grid = lmc_grid(ny, nx, nc), block = lmc_block();
  const float* py = pin >= 0 ? b.P[pin][0] : nullptr;
  const float* px = pin >= 0 ? b.P[pin][1] : nullptr;
  if (fgp) {
    const float* ry = py;
    const float* rx = px;
    int rin = -1;
    for (int tr = 0; tr < niter; ++tr) {
      const int pout = pin == 0 ? 1 : 0;
      const int rout = rin == 0 ? 1 : 0;
      blk_fgp_trip<<<grid, block, 0, s>>>(f, ry, rx, py, px, b.P[pout][0],
                                          b.P[pout][1], b.R[rout][0],
                                          b.R[rout][1], ny, nx, inv_gamma,
                                          0.125f, fgp_coef[tr]);
      pin = pout;
      rin = rout;
      py = b.P[pin][0];
      px = b.P[pin][1];
      ry = b.R[rin][0];
      rx = b.R[rin][1];
    }
  } else {
    for (int tr = 0; tr < niter; ++tr) {
      const int pout = pin == 0 ? 1 : 0;
      blk_chambolle_trip<<<grid, block, 0, s>>>(f, py, px, b.P[pout][0],
                                                b.P[pout][1], ny, nx,
                                                inv_gamma, tv_step);
      pin = pout;
      py = b.P[pin][0];
      px = b.P[pin][1];
    }
  }
  return pin;
}

// Dual pair of P[idx], null for idx = -1 (the zero field).
static inline const float* lmc_dual_y(const DualBufs& b, int idx) {
  return idx >= 0 ? b.P[idx][0] : nullptr;
}
static inline const float* lmc_dual_x(const DualBufs& b, int idx) {
  return idx >= 0 ? b.P[idx][1] : nullptr;
}

// ULPDA's Gradient2D dual projection of (ty, tx): onto the l2 ball of radius
// g_sigma (l21; g_sigma / n as (1 / n) * g_sigma, as torch divides a Python
// scalar by a tensor) or the l-inf box (l1).
__device__ __forceinline__ void lmc_project_dual(float ty, float tx,
                                                 float g_sigma, int l21,
                                                 float* py, float* px) {
  if (l21) {
    const float nrm = sqrtf(ty * ty + tx * tx);
    const float scale = fminf((1.0f / fmaxf(nrm, 1e-30f)) * g_sigma, 1.0f);
    *py = ty * scale;
    *px = tx * scale;
  } else {
    *py = fminf(fmaxf(ty, -g_sigma), g_sigma);
    *px = fminf(fmaxf(tx, -g_sigma), g_sigma);
  }
}

// --- halo tiles in shared memory (tiled_block.cu, tv_prox.cu) ---------------
// A CTA of the tile kernels owns an interior of ty x tx pixels at image
// (blockIdx.y ty, blockIdx.x tx) and holds the sy x sx = (ty + 2h) x (tx + 2h)
// tile around it in shared memory, read with image-periodic wrap: tile pixel
// (r, c) is image pixel (gr[r], gc[c]). A stencil takes a neighbour past the
// tile's edge as 0; the error that makes travels one pixel per application
// (one TV dual trip, one gram radius), so a halo deeper than a step's reach
// leaves the interior exact. The forward-difference masks sit at image row
// ny - 1 and column nx - 1 wherever those fall in the tile
// (myula_tiled.py::_band_masks), so the Neumann TV boundary is exact too:
// each interior pixel takes the same operations on the same values as in
// the whole-image kernels 2 and 3, and the results agree bit for bit.

#define LMC_MAXTRIP 64  // TV dual trips and Chebyshev sweeps of a tile step

struct TileGeo {
  int ny, nx, ty, tx, h, sy, sx;
  int dr, dc;     // a stride of blockDim.x pixels in rows and columns
  const int* gr;  // image row of each tile row (shared memory)
  const int* gc;  // image column of each tile column
};

// A strided loop of the CTA's threads over the tile's pixels li = r sx + c,
// stepping (r, c) without a division per pixel.
#define LMC_TILE_LOOP(t, li, r, c)                                         \
  for (int li = threadIdx.x, r = threadIdx.x / (t).sx,                      \
           c = threadIdx.x % (t).sx;                                        \
       li < (t).sy * (t).sx; li += blockDim.x, r += (t).dr, c += (t).dc,   \
           r += c >= (t).sx ? 1 : 0, c -= c >= (t).sx ? (t).sx : 0)

// The CTA's tile geometry; fills gr and gc at ints (sy + sx ints of shared
// memory). Every thread calls it; synchronise before reading gr/gc.
__device__ __forceinline__ TileGeo lmc_tile_geo(int* ints, int ny, int nx,
                                                int ty, int tx, int h) {
  TileGeo t;
  t.ny = ny;
  t.nx = nx;
  t.ty = ty;
  t.tx = tx;
  t.h = h;
  t.sy = ty + 2 * h;
  t.sx = tx + 2 * h;
  t.dr = blockDim.x / t.sx;
  t.dc = blockDim.x % t.sx;
  int* gr = ints;
  int* gc = ints + t.sy;
  const int y0 = blockIdx.y * ty - h, x0 = blockIdx.x * tx - h;
  for (int r = threadIdx.x; r < t.sy; r += blockDim.x) gr[r] = wrap(y0 + r, ny);
  for (int c = threadIdx.x; c < t.sx; c += blockDim.x) gc[c] = wrap(x0 + c, nx);
  t.gr = gr;
  t.gc = gc;
  return t;
}

// Image index of tile pixel (r, c).
__device__ __forceinline__ size_t lmc_tile_k(int r, int c, const TileGeo& t) {
  return (size_t)t.gr[r] * t.nx + t.gc[c];
}

// Tile pixel (r, c), lt = r sx + c, of interior pixel li (ty x tx,
// row-major) and its image index; false past the image (a ragged last tile).
__device__ __forceinline__ bool lmc_tile_inner(int li, const TileGeo& t,
                                               int* lt, int* r, int* c,
                                               size_t* k) {
  const int ii = li / t.tx, jj = li % t.tx;
  const int gi = blockIdx.y * t.ty + ii, gj = blockIdx.x * t.tx + jj;
  if (gi >= t.ny || gj >= t.nx) return false;
  *r = t.h + ii;
  *c = t.h + jj;
  *lt = *r * t.sx + *c;
  *k = (size_t)gi * t.nx + gj;
  return true;
}

__device__ __forceinline__ void lmc_tile_load(float* buf,
                                              const float* __restrict__ src,
                                              const TileGeo& t) {
  LMC_TILE_LOOP(t, li, r, c) buf[li] = src[lmc_tile_k(r, c, t)];
}

// Edge-free tiles (kFree in the helpers below): a tile whose rows and
// columns avoid image row ny - 1 and column nx - 1 (no wrap, not the last
// row or column of tiles) has every forward-difference mask at "keep". Its
// helpers drop the mask lookups and the tile-edge checks, so a caller that
// stays off the tile's first and last rows and columns (a cone grown by at
// most h - 1) takes the same operations on the same values. The CTA decides
// once, uniformly, from its tile position.
__device__ __forceinline__ bool lmc_tile_free(const TileGeo& t) {
  const int y0 = blockIdx.y * t.ty - t.h, x0 = blockIdx.x * t.tx - t.h;
  return y0 >= 0 && x0 >= 0 && y0 + t.sy <= t.ny - 1 && x0 + t.sx <= t.nx - 1;
}

// lmc_div at tile pixel li = (r, c): the divergence with the dual masked at
// the image's last row/column.
template <bool kFree = false>
__device__ __forceinline__ float lmc_tile_div(const float* py, const float* px,
                                              int li, int r, int c,
                                              const TileGeo& t) {
  if (kFree) return (py[li] - py[li - t.sx]) + (px[li] - px[li - 1]);
  const float a = t.gr[r] != t.ny - 1 ? py[li] : 0.0f;
  const float b = (r > 0 && t.gr[r - 1] != t.ny - 1) ? py[li - t.sx] : 0.0f;
  const float cc = t.gc[c] != t.nx - 1 ? px[li] : 0.0f;
  const float d = (c > 0 && t.gc[c - 1] != t.nx - 1) ? px[li - 1] : 0.0f;
  return (a - b) + (cc - d);
}

// Forward differences of f at tile pixel li, zero at the image's last
// row/column.
template <bool kFree = false>
__device__ __forceinline__ void lmc_tile_fwd(const float* f, int li, int r,
                                             int c, const TileGeo& t,
                                             float* gy, float* gx) {
  if (kFree) {
    *gy = f[li + t.sx] - f[li];
    *gx = f[li + 1] - f[li];
    return;
  }
  *gy = (t.gr[r] != t.ny - 1 && r + 1 < t.sy) ? f[li + t.sx] - f[li] : 0.0f;
  *gx = (t.gc[c] != t.nx - 1 && c + 1 < t.sx) ? f[li + 1] - f[li] : 0.0f;
}

// rowconv then colconv of rank rr (blk_rowconv / blk_colconv's order) over
// the whole tile: acc over the column taps of u into tmp, a barrier, acc over
// the row taps of tmp summed over the ranks into gu, a barrier. Taps past the
// tile's edge count 0.
__device__ void lmc_tile_gram(const float* u, float* tmp, float* gu,
                              const Taps& tp, const TileGeo& t) {
  for (int rr = 0; rr < tp.rank; ++rr) {
    LMC_TILE_LOOP(t, li, r, c) {
      float acc = 0.0f;
      bool first = true;
      for (int b = 0; b < tp.kx; ++b) {
        const float w = tp.wx[rr][b];
        if (w == 0.0f) continue;
        const int cc = c - b + tp.ox;
        const float term = (cc >= 0 && cc < t.sx) ? u[r * t.sx + cc] * w : 0.0f;
        acc = first ? term : acc + term;
        first = false;
      }
      tmp[li] = acc;
    }
    __syncthreads();
    LMC_TILE_LOOP(t, li, r, c) {
      float acc = 0.0f;
      bool first = true;
      for (int a = 0; a < tp.ky; ++a) {
        const float w = tp.wy[rr][a];
        if (w == 0.0f) continue;
        const int rs = r - a + tp.oy;
        const float term = (rs >= 0 && rs < t.sy) ? tmp[rs * t.sx + c] * w : 0.0f;
        acc = first ? term : acc + term;
        first = false;
      }
      gu[li] = rr == 0 ? acc : gu[li] + acc;
    }
    __syncthreads();
  }
}

// --- the dependency cone of a tile's interior (kernel 2's resident route,
// kernel 6) -------------------------------------------------------------------

// A rectangle of the tile: rows [r0, r0 + nh), columns [c0, c0 + nw).
struct Rect {
  int r0, c0, nh, nw;
};

// The interior grown by e on every side, at most to the tile's edge.
__device__ __forceinline__ Rect rs_grown(const TileGeo& t, int e) {
  const int g = e < t.h ? e : t.h;
  return Rect{t.h - g, t.h - g, t.ty + 2 * g, t.tx + 2 * g};
}

// fn(li, r, c) for each pixel of R, strided over the CTA's threads without a
// division per pixel.
template <typename F>
__device__ __forceinline__ void rs_rect(const Rect& R, int sx, F&& fn) {
  const int dr = blockDim.x / R.nw, dc = blockDim.x % R.nw;
  int r = R.r0 + threadIdx.x / R.nw, c = R.c0 + threadIdx.x % R.nw;
  for (int q = threadIdx.x; q < R.nh * R.nw; q += blockDim.x) {
    fn(r * sx + c, r, c);
    r += dr;
    c += dc;
    if (c >= R.c0 + R.nw) {
      c -= R.nw;
      ++r;
    }
  }
}

// The gram where the interior's data gradient reads it: the row pass (the
// column taps) on the interior's columns and the rows within the row taps'
// reach ry of it, then the column pass on the interior (lmc_tile_gram's
// arithmetic; gu then holds A^T A x on the interior only, at the tile's
// index, or with kInnerOut in a ty x tx buffer at the interior's index); a
// barrier after each pass. The taps never leave the tile (h >= the taps'
// reach), so kFree drops the tile-edge checks.
template <bool kFree = false, bool kInnerOut = false>
__device__ void rs_gram(const float* u, float* tmp, float* gu, const Taps& tp,
                        const TileGeo& t, int ry) {
  const Rect rows{t.h - ry, t.h, t.ty + 2 * ry, t.tx};
  const Rect inner = rs_grown(t, 0);
  for (int rr = 0; rr < tp.rank; ++rr) {
    rs_rect(rows, t.sx, [&](int li, int r, int c) {
      float acc = 0.0f;
      bool first = true;
      for (int b = 0; b < tp.kx; ++b) {
        const float w = tp.wx[rr][b];
        if (w == 0.0f) continue;
        const int cc = c - b + tp.ox;
        const float term =
            (kFree || (cc >= 0 && cc < t.sx)) ? u[r * t.sx + cc] * w : 0.0f;
        acc = first ? term : acc + term;
        first = false;
      }
      tmp[li] = acc;
    });
    __syncthreads();
    rs_rect(inner, t.sx, [&](int li, int r, int c) {
      float acc = 0.0f;
      bool first = true;
      for (int a = 0; a < tp.ky; ++a) {
        const float w = tp.wy[rr][a];
        if (w == 0.0f) continue;
        const int rs = r - a + tp.oy;
        const float term =
            (kFree || (rs >= 0 && rs < t.sy)) ? tmp[rs * t.sx + c] * w : 0.0f;
        acc = first ? term : acc + term;
        first = false;
      }
      const int o = kInnerOut ? (r - t.h) * t.tx + (c - t.h) : li;
      gu[o] = rr == 0 ? acc : gu[o] + acc;
    });
    __syncthreads();
  }
}

// niter trips of the TV prox of the tile f at 1/gamma = inv_gamma, Chambolle
// at p.tv_step (kRecip: lmc_chambolle_point's one reciprocal and two
// multiplies, else kernel 1's two divisions) or FGP (p.fgp) with
// momentum coef (blk_fgp_trip's), from the dual (py, px) = (sy_, sx_) of the previous
// step in global memory (warm, every pixel exact) or from zeros; the FGP
// point (ry, rx) starts at the dual. Each trip computes only what the
// interior's prox reads after the last trip: trip tr computes u and then the
// dual on the interior grown by e = niter - tr. u reads the dual one pixel up
// and left, which the trip before computed exactly on the interior grown by
// e + 1, so u is exact on its rectangle; the dual update reads u one pixel
// down and right, so the dual is exact there but on its bottom and right
// edges, which nothing after reads. At the end the dual is exact on the
// interior and the ring above and left of it, which the divergence on the
// interior reads. Ends with a barrier. The trips stay e <= niter < h pixels
// off the tile's edge, so an edge-free tile takes kFree. With e0 > 0 every
// rectangle grows by e0 more: the prox is then read on the interior grown
// by e0 (kernel 3's resident route and kernel 7, ul_primal_cone).
template <bool kFree = false, bool kRecip = true, typename P>
__device__ void rs_trips(const P& p, const float* f, float* u,
                         float* py, float* px, float* ry, float* rx,
                         const float* sy_, const float* sx_, float inv_gamma,
                         int niter, const float* coef, const TileGeo& t,
                         int e0 = 0) {
  LMC_TILE_LOOP(t, li, r, c) {
    float a = 0.0f, b = 0.0f;
    if (sy_ != nullptr) {
      // loads of what other CTAs wrote in this launch go to L2 (__ldcg)
      const size_t k = lmc_tile_k(r, c, t);
      a = __ldcg(sy_ + k);
      b = __ldcg(sx_ + k);
    }
    py[li] = a;
    px[li] = b;
    if (p.fgp) {
      ry[li] = a;
      rx[li] = b;
    }
  }
  __syncthreads();
  // u reads the dual (Chambolle) or the FGP point
  const float* qy = p.fgp ? ry : py;
  const float* qx = p.fgp ? rx : px;
  for (int tr = 0; tr < niter; ++tr) {
    const int e = e0 + niter - tr;
    rs_rect(rs_grown(t, e), t.sx, [&](int li, int r, int c) {
      u[li] = lmc_tile_div<kFree>(qy, qx, li, r, c, t) - f[li] * inv_gamma;
    });
    __syncthreads();
    const float mom = p.fgp ? coef[tr] : 0.0f;
    rs_rect(rs_grown(t, e), t.sx, [&](int li, int r, int c) {
      float gy, gx;
      lmc_tile_fwd<kFree>(u, li, r, c, t, &gy, &gx);
      if (p.fgp) {
        const float ty = ry[li] + 0.125f * gy;
        const float tx = rx[li] + 0.125f * gx;
        const float scale = fminf(1.0f, rsqrtf(ty * ty + tx * tx));
        const float ay = ty * scale;
        const float ax = tx * scale;
        ry[li] = ay + mom * (ay - py[li]);
        rx[li] = ax + mom * (ax - px[li]);
        py[li] = ay;
        px[li] = ax;
      } else {
        const float mag = sqrtf(gy * gy + gx * gx);
        if (kRecip) {
          const float inv = 1.0f / (1.0f + p.tv_step * mag);
          py[li] = (py[li] + p.tv_step * gy) * inv;
          px[li] = (px[li] + p.tv_step * gx) * inv;
        } else {
          const float den = 1.0f + p.tv_step * mag;
          py[li] = (py[li] + p.tv_step * gy) / den;
          px[li] = (px[li] + p.tv_step * gx) / den;
        }
      }
    });
    __syncthreads();
  }
}

// Reach of the taps from a pixel: rows (ry) and columns (rx).
static inline int lmc_taps_reach_y(const Taps& tp) {
  return tp.oy > tp.ky - 1 - tp.oy ? tp.oy : tp.ky - 1 - tp.oy;
}
static inline int lmc_taps_reach_x(const Taps& tp) {
  return tp.ox > tp.kx - 1 - tp.ox ? tp.ox : tp.kx - 1 - tp.ox;
}

// --- ULPDA's primal step on the cone of a tile's interior (kernel 3's
// resident route, kernel 7) ---------------------------------------------------
// The step's operators read their input on a neighbourhood: sweep k of the
// niter_solve Chebyshev sweeps reads u one gram reach further out than it
// writes, the MC-TV clamp and the ME-TV envelope trips read v, v reads the
// dual one pixel up and left. With grow = reach, sweep k runs on the
// interior grown by grow (niter_solve - 1 - k), so rhs is needed on the
// interior grown by E = grow (niter_solve - 1), v on the interior grown by
// Ev = E (tv), E + 2 (mctv: the clamp on E + 1 reads v one pixel down and
// right) or E + niter_inner (metv: envelope trip tr on E + niter_inner - tr,
// rs_trips), x on the interior grown by E + reach and Ev, the dual on
// Ev + 1. With grow = 0 (kernel 3's resident route: split sweeps) every
// sweep runs on the interior and u is exchanged between the CTAs after each
// sweep but the last. The halo h = max(E + reach, Ev + 1) holds all of it,
// every stencil one pixel off the tile's edge, so an edge-free tile takes
// kFree.

// A nonzero tap of a gram pass: the offset of its input from the output
// pixel in the tile's row-major index, and its weight.
struct TapW {
  int off;
  float w;
};

struct UlpdaTile {
  // the gram's nonzero taps per rank, in tap order: the row pass (the
  // column taps wx) and the column pass (the row taps wy)
  int rank, nrow[LMC_MAXR], ncol[LMC_MAXR];
  TapW rtap[LMC_MAXR][LMC_MAXK], ctap[LMC_MAXR][LMC_MAXK];
  float tau, mu, theta, noise_amp, ts, g_sigma;
  float c_mc, gamma_mc, clamp_mc, c_me, inv_gamma_mc, tv_step;
  int niter_solve, mode, niter_inner, fgp, l21, ty, tx, h;
  int reach, ry;  // the taps' reach (rows and columns), the row taps' reach
  int grow;       // reach, or 0 with split sweeps
  float cheb[LMC_MAXTRIP][2];
  float fgp_coef[LMC_MAXTRIP];
};

// E and Ev above.
__host__ __device__ inline int ul_cone_rhs(int grow, int niter_solve) {
  return niter_solve > 0 ? grow * (niter_solve - 1) : 0;
}
__host__ __device__ inline int ul_cone_v(int grow, int niter_solve, int mode,
                                         int niter_inner) {
  const int e = ul_cone_rhs(grow, niter_solve);
  return e + (mode == MODE_MCTV ? 2 : (mode == MODE_METV ? niter_inner : 0));
}

// The halo of the cone, kernels/ulpda_fused.py::_ulpda_halo.
static inline int ul_halo(int reach, int grow, int niter_solve, int mode,
                          int niter_inner) {
  const int a = niter_solve > 0 ? ul_cone_rhs(grow, niter_solve) + reach : 0;
  const int b = ul_cone_v(grow, niter_solve, mode, niter_inner) + 1;
  return a > b ? a : b;
}

// p's tap lists from tp for a tile row of sx pixels: tap b of wx reads
// column c - b + ox, tap a of wy row r - a + oy (blk_rowconv, blk_colconv),
// zero taps dropped as those passes skip them.
static inline void ul_tap_lists(UlpdaTile* p, const Taps& tp, int sx) {
  p->rank = tp.rank;
  for (int rr = 0; rr < tp.rank; ++rr) {
    p->nrow[rr] = p->ncol[rr] = 0;
    for (int b = 0; b < tp.kx; ++b)
      if (tp.wx[rr][b] != 0.0f) p->rtap[rr][p->nrow[rr]++] = TapW{tp.ox - b, tp.wx[rr][b]};
    for (int a = 0; a < tp.ky; ++a)
      if (tp.wy[rr][a] != 0.0f)
        p->ctap[rr][p->ncol[rr]++] = TapW{(tp.oy - a) * sx, tp.wy[rr][a]};
  }
}

// The primal step of one CTA's tile up to the solve: x from src and the
// dual (py, px) from global memory (loads of what other CTAs may have
// written go to L2, __ldcg), v, the mode's correction and rhs
// (ul_primal_in, ul_mctv_rhs / ul_metv_rhs), then the Chebyshev sweeps warm
// started at x (blk_rowconv, blk_colconv and ul_cheb_sweep, the column pass
// of the last rank fused with the sweep), each on its cone. Ends with a
// barrier and u in X on the interior (x when niter_solve is 0). Tile fields:
// X (x, then u), V (v, then rhs), D and T (the dual, the MC-TV clamp or the
// envelope dual, then T the row pass and D the Chebyshev direction), G (the
// trips' u, then the gram's sum over the ranks but the last), RY and RX (the
// FGP point; metv with fgp only). The envelope dual starts from (ey, ex) in
// global memory (warm) or zeros, and with eo its interior goes out to eo.
// With split sweeps (grow 0), xch(sw) runs after each sweep but the last:
// the exchange of u, which leaves X exact on the interior grown by reach.
template <bool kFree, typename Xch>
__device__ void ul_primal_cone(const UlpdaTile& p, const float* src,
                               const float* py, const float* px,
                               const float* __restrict__ atb, const float* ey,
                               const float* ex, float* eo, float* X, float* V,
                               float* D, float* T, float* G, float* RY,
                               float* RX, const float* fgp_coef,
                               const float (*cheb)[2], const TileGeo& t,
                               Xch&& xch) {
  const int ns = p.niter_solve;
  const int E = ul_cone_rhs(p.grow, ns);
  const int Ev = ul_cone_v(p.grow, ns, p.mode, p.niter_inner);
  const int Lx = ns > 0 && E + p.reach > Ev ? E + p.reach : Ev;
  rs_rect(rs_grown(t, Lx), t.sx, [&](int li, int r, int c) {
    X[li] = __ldcg(src + lmc_tile_k(r, c, t));
  });
  rs_rect(rs_grown(t, Ev + 1), t.sx, [&](int li, int r, int c) {
    const size_t k = lmc_tile_k(r, c, t);
    D[li] = __ldcg(py + k);
    T[li] = __ldcg(px + k);
  });
  __syncthreads();
  // (1) v = x - tau A^T p, A^T p = -div p; in mode tv rhs = v + ts atb
  rs_rect(rs_grown(t, Ev), t.sx, [&](int li, int r, int c) {
    const float aty = -lmc_tile_div<kFree>(D, T, li, r, c, t);
    const float vv = X[li] - p.tau * aty;
    V[li] = p.mode == MODE_TV ? vv + p.ts * atb[lmc_tile_k(r, c, t)] : vv;
  });
  __syncthreads();
  // (2) the concave part's linearization, rhs in place of v
  if (p.mode == MODE_MCTV) {
    rs_rect(rs_grown(t, E + 1), t.sx, [&](int li, int r, int c) {
      float gy, gx;
      lmc_tile_fwd<kFree>(V, li, r, c, t, &gy, &gx);
      float mag = sqrtf(gy * gy + gx * gx);
      mag = (mag != 0.0f) ? mag : 1e-9f;
      const float clamp = fminf(1.0f / mag, p.clamp_mc);
      D[li] = clamp * gy;
      T[li] = clamp * gx;
    });
    __syncthreads();
    rs_rect(rs_grown(t, E), t.sx, [&](int li, int r, int c) {
      const float vv = V[li] - p.c_mc * lmc_tile_div<kFree>(D, T, li, r, c, t);
      V[li] = vv + p.ts * atb[lmc_tile_k(r, c, t)];
    });
    __syncthreads();
  } else if (p.mode == MODE_METV) {
    rs_trips<kFree>(p, V, G, D, T, RY, RX, ey, ex, p.inv_gamma_mc,
                    p.niter_inner, fgp_coef, t, E);
    rs_rect(rs_grown(t, E), t.sx, [&](int li, int r, int c) {
      const float vk = V[li];
      const float pe = vk - p.gamma_mc * lmc_tile_div<kFree>(D, T, li, r, c, t);
      const float vv = vk + p.c_me * (vk - pe);
      V[li] = vv + p.ts * atb[lmc_tile_k(r, c, t)];
    });
    if (eo != nullptr) {
      const size_t npix = (size_t)t.ny * t.nx;
      for (int li = threadIdx.x; li < t.ty * t.tx; li += blockDim.x) {
        int lt, r, c;
        size_t k;
        if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
        eo[k] = D[lt];
        eo[npix + k] = T[lt];
      }
    }
    __syncthreads();
  }
  // (3) the Chebyshev sweeps, sweep sw on the interior grown by
  // grow (ns - 1 - sw); X turns into u in place (the column pass reads only T)
  for (int sw = 0; sw < ns; ++sw) {
    const int e = p.grow * (ns - 1 - sw);
    const Rect rows{t.h - e - p.ry, t.h - e, t.ty + 2 * (e + p.ry),
                    t.tx + 2 * e};
    const float c_d = cheb[sw][0], c_r = cheb[sw][1];
    for (int rr = 0; rr < p.rank; ++rr) {
      // every tap stays in the tile (the halo holds the cone): no edge checks
      const int nr = p.nrow[rr], nc = p.ncol[rr];
      rs_rect(rows, t.sx, [&](int li, int r, int c) {
        float acc = nr > 0 ? X[li + p.rtap[rr][0].off] * p.rtap[rr][0].w : 0.0f;
#pragma unroll 4
        for (int j = 1; j < nr; ++j)
          acc = acc + X[li + p.rtap[rr][j].off] * p.rtap[rr][j].w;
        T[li] = acc;
      });
      __syncthreads();
      const bool last = rr == p.rank - 1;
      rs_rect(rs_grown(t, e), t.sx, [&](int li, int r, int c) {
        float acc = nc > 0 ? T[li + p.ctap[rr][0].off] * p.ctap[rr][0].w : 0.0f;
#pragma unroll 4
        for (int j = 1; j < nc; ++j)
          acc = acc + T[li + p.ctap[rr][j].off] * p.ctap[rr][j].w;
        const float gu = rr == 0 ? acc : G[li] + acc;
        if (!last) {
          G[li] = gu;
          return;
        }
        const float uk = X[li];
        const float res = V[li] - (uk + p.ts * gu);
        const float dk = sw == 0 ? res * c_r : c_d * D[li] + c_r * res;
        D[li] = dk;
        X[li] = uk + dk;
      });
      __syncthreads();
    }
    if (p.grow == 0 && sw + 1 < ns) xch(sw);
  }
}

}  // namespace
