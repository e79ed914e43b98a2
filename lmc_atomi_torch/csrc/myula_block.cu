// Kernel 2: n_steps fused MYULA steps on the TV-deblurring posterior, with
// streaming Welford moments and P^2 quantile markers.
//
// Replaces lmc_atomi_tpu/kernels/myula_fused.py::myula_tv_block_update
// (_block_kernel), which runs a whole block of steps inside one TPU core with
// every field resident in VMEM. Hopper has no 128 MiB scratch, so the fields
// stay in global memory (at 512^2 the ~20 MiB of a 95%-CI run fits the 50 MB
// L2) and one host call issues, for each step g = step0 + i:
//   (a) two separable wrap-convolution passes, grad = sigma A^T A x - sigma A^T b
//       with A^T A = sum_r wy_r wx_r^T (row pass, then column pass);
//   (b) niter_tv dual trips, Chambolle or FGP, ping-ponged between buffers
//       (with tv_warm the dual carries across the steps of one call and starts
//       from zeros at each call, as on the TPU);
//   (c) one elementwise launch: x - gamma div p, the MYULA update, the Philox
//       normal at (seed, chain, pixel, g), burn-in-masked Welford, and P^2.
// Each launch is bound by device-memory bytes and, at 512^2, by launch
// latency: a cold-10 step is 13 launches of a few us. Persistent launches,
// shared-memory row bands and CUDA graphs are later work.
#include "tv_common.cuh"

#define LMC_MAXR 4
#define LMC_MAXK 32
#define LMC_MAXQ 4

namespace {

struct Taps {
  int rank, ky, kx, oy, ox;
  float wy[LMC_MAXR][LMC_MAXK];
  float wx[LMC_MAXR][LMC_MAXK];
};

struct UpdateParams {
  float c_keep, c_grad, c_prox, noise_amp, tv_gamma;
  float w, inv_denom;
  int with_noise, with_stats, n_q, c_prev;
  uint32_t seed, chain, step;
  float qcoef[LMC_MAXQ][3];
};

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

// grad[i, j] = sigma * sum_r sum_a wy_r[a] tmp[r, (i - a + oy) mod ny, j] - atbs[i, j]
__global__ void blk_colconv(const float* __restrict__ tmp,
                            const float* __restrict__ atbs,
                            float* __restrict__ grad, int ny, int nx, Taps t,
                            float sigma) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  float out = 0.0f;
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
    out = (r == 0) ? acc : out + acc;
  }
  const int k = i * nx + j;
  grad[k] = sigma * out - atbs[k];
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
__device__ __forceinline__ void p2_update(float x, float q[5], float n3[3],
                                          int c_prev, const float coef[3]) {
  if (c_prev < 5) {
    q[c_prev] = x;
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

// (c): prox, MYULA update, noise, Welford and P^2, in place on x/mean/m2/qh/qn.
__global__ void blk_update(float* __restrict__ x, const float* __restrict__ grad,
                           const float* __restrict__ py,
                           const float* __restrict__ px,
                           float* __restrict__ mean, float* __restrict__ m2,
                           float* __restrict__ qh, float* __restrict__ qn,
                           int ny, int nx, UpdateParams u) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const size_t npix = (size_t)ny * nx;
  const float xv = x[k];
  const float prox = xv - u.tv_gamma * lmc_div(py, px, i, j, ny, nx);
  float xn = u.c_keep * xv - u.c_grad * grad[k] + u.c_prox * prox;
  if (u.with_noise) {
    xn = xn + u.noise_amp * lmc_normal(u.seed, u.chain, (uint32_t)k, u.step);
  }
  x[k] = xn;
  if (u.with_stats) {
    const float mu = mean[k];
    const float delta = xn - mu;
    // delta / n as delta * (1 / n), as torch divides by a Python scalar
    const float mu_new = mu + u.w * delta * u.inv_denom;
    mean[k] = mu_new;
    m2[k] = m2[k] + u.w * delta * (xn - mu_new);
  }
  for (int jq = 0; jq < u.n_q; ++jq) {
    float q[5], n3[3];
#pragma unroll
    for (int m = 0; m < 5; ++m) q[m] = qh[(5 * jq + m) * npix + k];
#pragma unroll
    for (int m = 0; m < 3; ++m) n3[m] = qn[(3 * jq + m) * npix + k];
    p2_update(xn, q, n3, u.c_prev, u.qcoef[jq]);
#pragma unroll
    for (int m = 0; m < 5; ++m) qh[(5 * jq + m) * npix + k] = q[m];
#pragma unroll
    for (int m = 0; m < 3; ++m) qn[(3 * jq + m) * npix + k] = n3[m];
  }
}

}  // namespace

// One call runs n_steps MYULA steps in place on x, mean, m2, qh, qn (float32,
// row-major, contiguous, on the current device).
//   grad: (ny, nx) scratch; tmp: (rank, ny, nx) scratch; duals: (8, ny, nx).
//   taps: host, rank * (ky + kx) floats, for each rank wy then wx.
//   coef: host, 6 floats [1 - tau/gamma, tau, tau/gamma,
//         noise_scale * sqrt(2 tau), sigma, tv_gamma].
//   fgp_coef: host, niter_tv floats (FGP momentum; ignored for Chambolle).
//   qcoef: host, n_q * 3 floats (dn - 1) / 4 for the interior markers.
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the supported range.
extern "C" int lmc_myula_block(
    float* x, const float* atbs, float* mean, float* m2, float* qh, float* qn,
    float* grad, float* tmp, float* duals, int ny, int nx, const float* taps,
    int rank, int ky, int kx, int oy, int ox, int n_steps, int niter_tv,
    float tv_step, int fgp, const float* fgp_coef, int tv_warm, int with_noise,
    int with_stats, const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, void* stream) {
  if (rank < 1 || rank > LMC_MAXR || ky > LMC_MAXK || kx > LMC_MAXK ||
      n_q < 0 || n_q > LMC_MAXQ || thin < 1 || ny < 2 || nx < 2)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  const size_t npix = (size_t)ny * nx;

  Taps t;
  t.rank = rank;
  t.ky = ky;
  t.kx = kx;
  t.oy = oy;
  t.ox = ox;
  for (int r = 0; r < rank; ++r) {
    const float* base = taps + (size_t)r * (ky + kx);
    for (int a = 0; a < ky; ++a) t.wy[r][a] = base[a];
    for (int b = 0; b < kx; ++b) t.wx[r][b] = base[ky + b];
  }

  UpdateParams u;
  u.c_keep = coef[0];
  u.c_grad = coef[1];
  u.c_prox = coef[2];
  u.noise_amp = coef[3];
  u.tv_gamma = coef[5];
  u.with_noise = with_noise;
  u.with_stats = with_stats;
  u.seed = seed;
  u.chain = chain;
  for (int jq = 0; jq < n_q; ++jq)
    for (int m = 0; m < 3; ++m) u.qcoef[jq][m] = qcoef[3 * jq + m];
  const float sigma = coef[4];
  const float inv_tv_gamma = 1.0f / coef[5];

  // dual buffers: P[0], P[1] hold the iterate p, R[0], R[1] the FGP point r
  float* P[2][2] = {{duals, duals + npix}, {duals + 2 * npix, duals + 3 * npix}};
  float* R[2][2] = {{duals + 4 * npix, duals + 5 * npix},
                    {duals + 6 * npix, duals + 7 * npix}};
  int cur = -1;  // index into P of the carried dual; -1 is the zero field

  for (int it = 0; it < n_steps; ++it) {
    const long long g = step0 + it;
    blk_rowconv<<<grid, block, 0, s>>>(x, tmp, ny, nx, t);
    blk_colconv<<<grid, block, 0, s>>>(tmp, atbs, grad, ny, nx, t, sigma);

    int pin = tv_warm ? cur : -1;
    const float* py = pin >= 0 ? P[pin][0] : nullptr;
    const float* px = pin >= 0 ? P[pin][1] : nullptr;
    if (fgp) {
      const float* ry = py;
      const float* rx = px;
      int rin = -1;
      for (int tr = 0; tr < niter_tv; ++tr) {
        const int pout = pin == 0 ? 1 : 0;
        const int rout = rin == 0 ? 1 : 0;
        blk_fgp_trip<<<grid, block, 0, s>>>(x, ry, rx, py, px, P[pout][0],
                                            P[pout][1], R[rout][0], R[rout][1],
                                            ny, nx, inv_tv_gamma, 0.125f,
                                            fgp_coef[tr]);
        pin = pout;
        rin = rout;
        py = P[pin][0];
        px = P[pin][1];
        ry = R[rin][0];
        rx = R[rin][1];
      }
    } else {
      for (int tr = 0; tr < niter_tv; ++tr) {
        const int pout = pin == 0 ? 1 : 0;
        blk_chambolle_trip<<<grid, block, 0, s>>>(x, py, px, P[pout][0],
                                                  P[pout][1], ny, nx,
                                                  inv_tv_gamma, tv_step);
        pin = pout;
        py = P[pin][0];
        px = P[pin][1];
      }
    }
    cur = pin;

    // weighted Welford count: cnt0 + steps of this call at or past burn-in
    const bool w = g >= burn;
    long long lo = burn > step0 ? burn : step0;
    long long n_new = cnt0 + (g + 1 - lo > 0 ? g + 1 - lo : 0);
    u.w = w ? 1.0f : 0.0f;
    u.inv_denom = 1.0f / (float)(n_new > 1 ? n_new : 1);
    u.step = (uint32_t)g;
    // P^2 observations recorded before this one (global, see _block_kernel)
    const bool record = n_q > 0 && w && (g + 1) % thin == 0;
    long long c_prev = g / thin - burn / thin;
    u.c_prev = (int)(c_prev > 0 ? c_prev : 0);
    u.n_q = record ? n_q : 0;
    blk_update<<<grid, block, 0, s>>>(x, grad, py, px, mean, m2, qh, qn, ny, nx,
                                      u);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
