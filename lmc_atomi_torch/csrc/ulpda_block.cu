// Kernel 3: n_steps fused ULPDA (Langevin primal-dual) steps on the
// deconvolution posterior, with streaming Welford moments.
//
// Replaces lmc_atomi_tpu/kernels/ulpda_fused.py::ulpda_block_update
// (_ulpda_kernel), which keeps x, the dual and the moments of a whole block of
// steps in one TPU core's VMEM. Here every field stays in global memory (at
// 512^2 the ~15 fields of a block fit the 50 MB L2) and one host call makes,
// for each step g = step0 + i, a sequence of one-thread-per-pixel launches:
//   gfirst: (0) the dual update from the incoming xbar;
//   (1) v = x - tau A^T y with A^T y = -div y (the Gradient2D duals) or
//       A^T y = W^T y (the wl1 dual, W the interleaved Haar transform);
//   (2) the data term's concave-part linearization of v:
//       mctv: the clamped gradient min(1/gamma, 1/|Gv|) Gv, then
//             v - tau lamda div(clamp Gv);
//       metv: niter_inner Chambolle or FGP trips of the envelope prox p of v
//             at gamma_mc, then v + (tau lamda / gamma_mc)(v - p);
//       and rhs = v + tau sigma A^T b (fused into the last launch of (1)/(2));
//   (3) niter_solve Chebyshev sweeps for (I + tau sigma A^T A) u = rhs, warm
//       started at x, spectrum bound [1, 1 + tau sigma lam]: each sweep is the
//       row and column wrap-convolution passes of A^T A plus one elementwise
//       launch of the residual r, the direction d and u;
//   (4) x' = u + noise_scale sqrt(2 tau) xi with the Philox normal at
//       (seed, chain, pixel, g), xbar = x' + theta (x' - x), Welford;
//   not gfirst: (5) the dual update y <- proj(y + mu G xbar), a launch of its
//       own because it reads xbar on the pixel's neighbours.
// The dual update reads only its own pixel's dual, so it runs in place. The
// wl1 dual (the "wl1" of kernels/ulpda_fused.py, deconvolution model M10) is
// one coefficient field: (0)/(5) is y <- clip(y + mu W xbar) and (1) reads
// W^T y, each one launch whose CTAs own whole 2^levels tiles and run the
// transform in shared memory (block_common.cuh: lmc_haar_fwd/inv, shared
// with kernels 4 and 5). Past 5 levels a 2^levels tile outgrows a CTA's
// 32 x 32 region, and each transform takes one launch per level and axis
// with the Haar butterfly of kernel 4's per-level passes (lmc_haar_point).
// The gram passes are not tile-local, so the step stays a launch sequence.
// Every launch is bound by device-memory bytes and, at 512^2, by launch
// latency: a TV step with 3 sweeps is 12 launches of a few us. Persistent
// launches, shared-memory row bands and CUDA graphs are later work.
#include "block_common.cuh"

namespace {

enum { MODE_TV = 0, MODE_MCTV = 1, MODE_METV = 2 };
enum { DUAL_L1 = 0, DUAL_L21 = 1, DUAL_WL1 = 2 };  // ulpda_fused.py: DUALS

// (1): v = x - tau (-div y); in mode tv also rhs = v + ts atb.
__global__ void ul_primal_in(const float* __restrict__ x,
                             const float* __restrict__ py,
                             const float* __restrict__ px,
                             const float* __restrict__ atb,
                             float* __restrict__ v, float* __restrict__ rhs,
                             int ny, int nx, float tau, float ts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float aty = -lmc_div(py, px, i, j, ny, nx);
  const float vv = x[k] - tau * aty;
  if (rhs) {
    rhs[k] = vv + ts * atb[k];
  } else {
    v[k] = vv;
  }
}

// (2) mctv: rhs = (v - c (div c)) + ts atb, c = tau lamda, (cy, cx) the clamp.
__global__ void ul_mctv_rhs(const float* __restrict__ v,
                            const float* __restrict__ cy,
                            const float* __restrict__ cx,
                            const float* __restrict__ atb,
                            float* __restrict__ rhs, int ny, int nx, float c,
                            float ts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float vv = v[k] - c * lmc_div(cy, cx, i, j, ny, nx);
  rhs[k] = vv + ts * atb[k];
}

// (2) metv: p = v - gamma div e, rhs = (v + c (v - p)) + ts atb,
// c = tau lamda / gamma, (ey, ex) the envelope dual.
__global__ void ul_metv_rhs(const float* __restrict__ v,
                            const float* __restrict__ ey,
                            const float* __restrict__ ex,
                            const float* __restrict__ atb,
                            float* __restrict__ rhs, int ny, int nx,
                            float gamma, float c, float ts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float vk = v[k];
  const float p = vk - gamma * lmc_div(ey, ex, i, j, ny, nx);
  const float vv = vk + c * (vk - p);
  rhs[k] = vv + ts * atb[k];
}

// (3) one Chebyshev sweep after the gram passes gu = A^T A u_in:
//   r = rhs - (u_in + ts gu); d = first ? r c_r : c_d d + c_r r; u = u_in + d.
// After the first sweep u_in and u_out are one buffer.
__global__ void ul_cheb_sweep(const float* u_in, const float* __restrict__ gu,
                              const float* __restrict__ rhs,
                              float* __restrict__ d, float* u_out,
                              int ny, int nx, float ts, float c_d, float c_r,
                              int first) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float uk = u_in[k];
  const float r = rhs[k] - (uk + ts * gu[k]);
  const float dk = first ? r * c_r : c_d * d[k] + c_r * r;
  d[k] = dk;
  u_out[k] = uk + dk;
}

struct FinishParams {
  float noise_amp, theta, w, inv_denom;
  int with_noise, with_stats;
  uint32_t seed, chain, step;
};

// (4): x' = u + noise, xbar = x' + theta (x' - x), Welford; in place on x
// (u is x itself when the solve has no sweeps).
__global__ void ul_finish(float* x, const float* u,
                          float* __restrict__ xbar, float* __restrict__ mean,
                          float* __restrict__ m2, int ny, int nx,
                          FinishParams f) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float xo = x[k];
  float xn = u[k];
  if (f.with_noise) {
    xn = xn + f.noise_amp * lmc_normal(f.seed, f.chain, (uint32_t)k, f.step);
  }
  x[k] = xn;
  xbar[k] = xn + f.theta * (xn - xo);
  if (f.with_stats) {
    const float mu = mean[k];
    const float delta = xn - mu;
    const float mu_new = mu + f.w * delta * f.inv_denom;
    mean[k] = mu_new;
    m2[k] = m2[k] + f.w * delta * (xn - mu_new);
  }
}

// (0)/(5): y <- proj(y + mu G xbar), onto the per-pixel l2 ball of radius
// g_sigma (l21) or the l-inf box (l1); in place on (py, px).
__global__ void ul_dual(const float* __restrict__ xbar, float* __restrict__ py,
                        float* __restrict__ px, int ny, int nx, float mu,
                        float g_sigma, int l21) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float gy = (i < ny - 1) ? xbar[k + nx] - xbar[k] : 0.0f;
  const float gx = (j < nx - 1) ? xbar[k + 1] - xbar[k] : 0.0f;
  lmc_project_dual(py[k] + mu * gy, px[k] + mu * gx, g_sigma, l21, &py[k],
                   &px[k]);
}

// (1) wl1: v = x - tau W^T py; in mode tv also rhs = v + ts atb. One CTA per
// rh x rw region of whole Haar tiles.
__global__ void __launch_bounds__(LMC_TILE_THREADS)
ul_wl1_primal_in(const float* __restrict__ x, const float* __restrict__ py,
                 const float* __restrict__ atb, float* __restrict__ v,
                 float* __restrict__ rhs, int nx, int rh, int rw, int levels,
                 float tau, float ts) {
  __shared__ float buf[LMC_TILE_SIDE * LMC_TILE_SIDE];
  for (int li = threadIdx.x; li < rh * rw; li += blockDim.x)
    buf[li] = py[lmc_region_pixel(li, rh, rw, nx)];
  __syncthreads();
  lmc_haar_inv(buf, rh, rw, levels);
  for (int li = threadIdx.x; li < rh * rw; li += blockDim.x) {
    const int k = lmc_region_pixel(li, rh, rw, nx);
    const float vv = x[k] - tau * buf[li];
    if (rhs) {
      rhs[k] = vv + ts * atb[k];
    } else {
      v[k] = vv;
    }
  }
}

// (0)/(5) wl1: py <- clip(py + mu W xbar, -g_sigma, g_sigma), in place.
__global__ void __launch_bounds__(LMC_TILE_THREADS)
ul_wl1_dual(const float* __restrict__ xbar, float* __restrict__ py, int nx,
            int rh, int rw, int levels, float mu, float g_sigma) {
  __shared__ float buf[LMC_TILE_SIDE * LMC_TILE_SIDE];
  for (int li = threadIdx.x; li < rh * rw; li += blockDim.x)
    buf[li] = xbar[lmc_region_pixel(li, rh, rw, nx)];
  __syncthreads();
  lmc_haar_fwd(buf, rh, rw, levels);
  for (int li = threadIdx.x; li < rh * rw; li += blockDim.x) {
    const int k = lmc_region_pixel(li, rh, rw, nx);
    py[k] = fminf(fmaxf(py[k] + mu * buf[li], -g_sigma), g_sigma);
  }
}

// The wl1 dual past a CTA's region (2^levels > LMC_TILE_SIDE): one launch
// per Haar level and axis over the whole image (lmc_haar_point, kernel 4's
// per-level passes), out = the pass of in; the last pass of a transform
// runs the epilogue in place of the write: py <- clip(py + mu w, g_sigma)
// after W xbar (0)/(5), or v = x - tau w after W^T py (1), written as
// rhs = v + ts atb in mode tv (rhs non-null), else to v.
struct Wl1Epi {
  int kind;  // 0 none, 1 the dual update, 2 the primal input
  float* py;
  const float* x;
  const float* atb;
  float* v;
  float* rhs;
  float mu, g_sigma, tau, ts;
};

__global__ void ul_wl1_pass(const float* __restrict__ in,
                            float* __restrict__ out, int ny, int nx, int s,
                            int axis, Wl1Epi e) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float w = lmc_haar_point(in, ny, nx, i, j, s, axis);
  if (e.kind == 1) {
    e.py[k] = fminf(fmaxf(e.py[k] + e.mu * w, -e.g_sigma), e.g_sigma);
  } else if (e.kind == 2) {
    const float vv = e.x[k] - e.tau * w;
    if (e.rhs) {
      e.rhs[k] = vv + e.ts * e.atb[k];
    } else {
      e.v[k] = vv;
    }
  } else {
    out[k] = w;
  }
}

// The forward (W) or inverse (W^T) transform of src through the ping-pong
// buffers bufs, levels >= 1, the epilogue on the last pass.
void ul_wl1_transform(const float* src, float* const bufs[2], int ny, int nx,
                      int levels, int inverse, Wl1Epi epi, cudaStream_t s) {
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  const Wl1Epi none{0, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
  int out = 0;
  for (int n = 0; n < levels; ++n) {
    const int lv = inverse ? levels - 1 - n : n;
    for (int a = 0; a < 2; ++a) {
      const bool last = n == levels - 1 && a == 1;
      ul_wl1_pass<<<grid, block, 0, s>>>(src, bufs[out], ny, nx, 1 << lv,
                                         inverse ? 1 - a : a, last ? epi : none);
      src = bufs[out];
      out ^= 1;
    }
  }
}

}  // namespace

// One call runs n_steps ULPDA steps in place on x, py, px, xbar, mean, m2
// (float32, row-major, contiguous, on the current device).
//   dual: 0 l1, 1 l21 (the Gradient2D dual (py, px)), 2 wl1 (py the
//   interleaved Haar coefficient dual of levels levels, px unused; each CTA
//   of its launches owns an rh x rw region of whole tiles, or, with
//   rh = rw = 0, one launch per level and axis with u and d as the
//   ping-pong buffers).
//   atb: A^T b (unscaled). With gfirst = 0 the incoming xbar is never read;
//   the outgoing one is the genuine x' + theta (x' - x) in both orders.
//   scratch, each (ny, nx): v, rhs, u, d, gu; tmp: (rank, ny, nx);
//   aux: (8, ny, nx) in mode metv (envelope duals), (2, ny, nx) in mode mctv
//   (the clamped gradient), null in mode tv.
//   taps: host, rank * (ky + kx) floats, for each rank wy then wx.
//   cheb: host, 2 * niter_solve floats, per sweep (c_d, c_r): the first sweep
//         takes d = r c_r with c_r = 1 / theta_cheb, sweep k > 0
//         d = c_d d + c_r r with c_d = rho_k rho_{k-1}, c_r = 2 rho_k / delta.
//   coef: host, 10 floats [tau, mu, theta, noise_scale * sqrt(2 tau),
//         tau * sigma, g_sigma, tau * lamda, gamma_mc, 1 / gamma_mc,
//         tau * lamda / gamma_mc] (the last four unused in mode tv).
//   fgp_coef: host, niter_inner floats (FGP momentum; ignored for Chambolle).
// With env_warm the envelope dual carries across this call's steps and starts
// from zeros at each call, as on the TPU.
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the supported range.
extern "C" int lmc_ulpda_block(
    float* x, float* py, float* px, float* xbar, const float* atb, float* mean,
    float* m2, float* v, float* rhs, float* u, float* d, float* gu, float* tmp,
    float* aux, int ny, int nx, const float* taps, int rank, int ky, int kx,
    int oy, int ox, int n_steps, int niter_solve, const float* cheb,
    int gfirst, int dual, int levels, int rh, int rw, int mode,
    int niter_inner, float tv_step, int fgp,
    const float* fgp_coef, int env_warm, int with_noise, int with_stats,
    const float* coef, unsigned int seed, unsigned int chain, long long step0,
    long long burn, long long cnt0, void* stream) {
  Taps t;
  if (!lmc_taps(&t, taps, rank, ky, kx, oy, ox) || ny < 2 || nx < 2 ||
      niter_solve < 0 || mode < MODE_TV || mode > MODE_METV ||
      (mode != MODE_TV && aux == nullptr) || dual < DUAL_L1 ||
      dual > DUAL_WL1 || (dual != DUAL_WL1 && px == nullptr) ||
      (dual == DUAL_WL1 && (rh > 0 || rw > 0) &&
       !lmc_region_ok(ny, nx, rh, rw, levels)) ||
      (dual == DUAL_WL1 && rh == 0 && rw == 0 && levels < 1))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  const size_t npix = (size_t)ny * nx;

  const float tau = coef[0], mu = coef[1], ts = coef[4], g_sigma = coef[5];
  const float c_mc = coef[6], gamma_mc = coef[7], clamp_mc = coef[8];
  const float c_me = coef[9];
  // x / gamma as x * (1 / gamma) with the reciprocal of the float gamma, as
  // torch divides a CUDA tensor by a Python scalar
  const float inv_gamma_mc = 1.0f / gamma_mc;
  FinishParams f;
  f.noise_amp = coef[3];
  f.theta = coef[2];
  f.with_noise = with_noise;
  f.with_stats = with_stats;
  f.seed = seed;
  f.chain = chain;

  const DualBufs envb = lmc_dual_bufs(aux, npix);
  int cur_env = -1;  // index into envb.P of the carried envelope dual
  const dim3 tgrid(rw > 0 ? nx / rw : 0, rh > 0 ? ny / rh : 0);
  const bool passes = dual == DUAL_WL1 && rh == 0;  // the per-level route
  float* const bufs[2] = {u, d};  // free between the steps' Chebyshev solves
  Wl1Epi epi{0, py, x, atb, v, nullptr, mu, g_sigma, tau, ts};
  auto dual_update = [&]() {
    if (passes) {
      epi.kind = 1;
      ul_wl1_transform(xbar, bufs, ny, nx, levels, 0, epi, s);
    } else if (dual == DUAL_WL1) {
      ul_wl1_dual<<<tgrid, LMC_TILE_THREADS, 0, s>>>(xbar, py, nx, rh, rw,
                                                      levels, mu, g_sigma);
    } else {
      ul_dual<<<grid, block, 0, s>>>(xbar, py, px, ny, nx, mu, g_sigma,
                                     dual == DUAL_L21);
    }
  };
  // (1), writing rhs in mode tv and v otherwise
  auto primal_in = [&](float* rhs_out) {
    if (passes) {
      epi.kind = 2;
      epi.rhs = rhs_out;
      ul_wl1_transform(py, bufs, ny, nx, levels, 1, epi, s);
    } else if (dual == DUAL_WL1) {
      ul_wl1_primal_in<<<tgrid, LMC_TILE_THREADS, 0, s>>>(
          x, py, atb, v, rhs_out, nx, rh, rw, levels, tau, ts);
    } else {
      ul_primal_in<<<grid, block, 0, s>>>(x, py, px, atb, v, rhs_out, ny, nx,
                                          tau, ts);
    }
  };

  for (int it = 0; it < n_steps; ++it) {
    const long long g = step0 + it;
    if (gfirst) dual_update();

    if (mode == MODE_TV) {
      primal_in(rhs);
    } else {
      primal_in(nullptr);
      if (mode == MODE_MCTV) {
        blk_mctv_clamp<<<grid, block, 0, s>>>(v, aux, aux + npix, ny, nx,
                                              clamp_mc);
        ul_mctv_rhs<<<grid, block, 0, s>>>(v, aux, aux + npix, atb, rhs, ny,
                                           nx, c_mc, ts);
      } else {
        cur_env = lmc_tv_trips(v, envb, env_warm ? cur_env : -1, niter_inner,
                               fgp, tv_step, fgp_coef, inv_gamma_mc, ny, nx, s);
        ul_metv_rhs<<<grid, block, 0, s>>>(v, lmc_dual_y(envb, cur_env),
                                           lmc_dual_x(envb, cur_env), atb, rhs,
                                           ny, nx, gamma_mc, c_me, ts);
      }
    }

    // Chebyshev semi-iteration warm started at x (u = x when niter_solve = 0)
    const float* u_cur = x;
    for (int sw = 0; sw < niter_solve; ++sw) {
      blk_rowconv<<<grid, block, 0, s>>>(u_cur, tmp, ny, nx, t);
      blk_colconv<<<grid, block, 0, s>>>(tmp, nullptr, gu, ny, nx, t, 1.0f);
      ul_cheb_sweep<<<grid, block, 0, s>>>(u_cur, gu, rhs, d, u, ny, nx, ts,
                                           cheb[2 * sw], cheb[2 * sw + 1],
                                           sw == 0);
      u_cur = u;
    }

    const bool w = g >= burn;
    long long lo = burn > step0 ? burn : step0;
    long long n_new = cnt0 + (g + 1 - lo > 0 ? g + 1 - lo : 0);
    f.w = w ? 1.0f : 0.0f;
    f.inv_denom = 1.0f / (float)(n_new > 1 ? n_new : 1);
    f.step = (uint32_t)g;
    ul_finish<<<grid, block, 0, s>>>(x, u_cur, xbar, mean, m2, ny, nx, f);

    if (!gfirst) dual_update();
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
