// Launch-level building blocks shared by the fused MYULA block (myula_block.cu)
// and the fused ULPDA block (ulpda_block.cu): the separable wrap-convolution
// passes of A^T A, the Chambolle and FGP dual trips of the TV prox and the
// host loop that launches them, and the MC-TV gradient clamp.
//
// One thread per pixel of a row-major (ny, nx) float32 field, every field in
// global memory (at 512^2 a block's working set stays in the 50 MB L2). Each
// kernel is bound by device-memory bytes and, at 512^2, by launch latency.
#pragma once

#include "tv_common.cuh"

#define LMC_MAXR 4
#define LMC_MAXK 32

namespace {

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

// tmp[r, i, j] = sum_b wx_r[b] x[i, (j - b + ox) mod nx]
__global__ void blk_rowconv(const float* __restrict__ x, float* __restrict__ tmp,
                            int ny, int nx, Taps t) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const float* row = x + (size_t)i * nx;
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
    tmp[(size_t)r * ny * nx + (size_t)i * nx + j] = acc;
  }
}

// out[i, j] = sum_r sum_a wy_r[a] tmp[r, (i - a + oy) mod ny, j], written as
// sigma * out - atbs[i, j] (the MYULA data gradient) or, with a null atbs,
// as A^T A x itself (the ULPDA gram apply).
__global__ void blk_colconv(const float* __restrict__ tmp,
                            const float* __restrict__ atbs,
                            float* __restrict__ out, int ny, int nx, Taps t,
                            float sigma) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  float sum = 0.0f;
  for (int r = 0; r < t.rank; ++r) {
    const float* plane = tmp + (size_t)r * ny * nx;
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
  lmc_chambolle_point<true>(x, py, px, qy, qx, inv_gamma, step, i, j, ny, nx);
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
// dual P[pin] (pin = -1: the zero field). Returns the index into P of the
// final dual (-1 when niter is 0 and the start was the zero field).
static inline int lmc_tv_trips(const float* f, const DualBufs& b, int pin,
                               int niter, bool fgp, float tv_step,
                               const float* fgp_coef, float inv_gamma,
                               int ny, int nx, cudaStream_t s) {
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
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

}  // namespace
