// Kernel 3: n_steps fused ULPDA (Langevin primal-dual) steps on the
// deconvolution posterior, with streaming Welford moments.
//
// Replaces lmc_atomi_tpu/kernels/ulpda_fused.py::ulpda_block_update
// (_ulpda_kernel), which keeps x, the dual and the moments of a whole block of
// steps in one TPU core's VMEM. Hopper has no such scratch, but at 512^2 a
// chain's state fits the shared memory of the card's SMs taken together. So
// the host call takes one of two routes, named by the caller before any
// launch (kernels/ulpda_fused.py::ulpda_resident_plan: ty > 0 here):
//
// Resident route (ul_resident_block, the Gradient2D duals): one cooperative
// launch runs the whole call, one CTA of 1024 threads per 2-D tile of the
// image, every CTA resident at once (the planner takes the least tile area
// over tilings of at most one CTA an SM). A CTA keeps its interior's mean
// and m2 in shared memory for the call and writes them back once at the end.
// A step is two phases with a grid barrier after each: the primal phase
// reads its tile of x (interior ty x tx, halo h) from one of two parity
// buffers and the dual around it, computes v, the MC-TV / ME-TV correction,
// rhs and the Chebyshev sweeps in shared memory on only the pixels its
// interior's result depends on (block_common.cuh: ul_primal_cone), and
// writes its interior's x' (to the other parity buffer) and xbar; the dual
// phase updates its interior's dual from xbar in global memory, in place
// (the barrier after the primal phase separates its writers from its
// readers). gfirst puts the dual phase first. With env_warm the ME-TV
// envelope dual goes through parity buffers too. The Chebyshev sweeps run
// split: each on the interior, u exchanged through two planes in device
// memory with a grid barrier after each sweep but the last, so the halo is
// the gram's reach or the correction's depth (4 in TV and MC-TV, 11 in
// ME-TV with 10 envelope trips, for a 5 x 5 blur). On the H100 that beat
// computing each sweep on its cone (kernel 7's form, h 12 and 19) by 0-18%
// per mode: the cone's extra pixels cost more than niter_solve - 1 grid
// barriers and the exchange (PERF.md §6). At 512^2 the exchange stays in
// the 50 MB L2; a step is bound by instruction issue in the gram passes and
// the envelope trips, then its four grid barriers and the update's Philox.
//
// Launch sequence (2048^2 and up, and the wl1 dual): every field stays in
// global memory (at 512^2 the ~15 fields of a block fit the 50 MB L2) and the
// host issues, for each step g = step0 + i, one-thread-per-pixel launches:
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
// Every launch is bound by device-memory bytes and, at 512^2, by launch
// latency (a TV step with 3 sweeps is 12 launches of a few us). At 2048^2 it
// is the whole-image yardstick of kernel 7.
//
// Chains: with a Gradient2D dual a call runs n_chains chains of one
// posterior (kernels/ulpda_fused.py::run_ulpda_fused_packed) as kernel 2
// does: a grid axis over the chains on the launch sequence, groups of G
// chains (ulpda_resident_plan) a cooperative launch on the resident route.
//
// Both routes take every pixel through the same float operations in the same
// order, so they equal the plain version bit for bit (chip_smoke.py checks it).
#include <cooperative_groups.h>

#include "block_common.cuh"

namespace {

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
  x = lmc_chain_at(x, ny, nx);
  py = lmc_chain_at(py, ny, nx);
  px = lmc_chain_at(px, ny, nx);
  v = lmc_chain_at(v, ny, nx);
  rhs = lmc_chain_at(rhs, ny, nx);
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
  v = lmc_chain_at(v, ny, nx);
  cy = lmc_chain_at(cy, ny, nx);
  cx = lmc_chain_at(cx, ny, nx);
  rhs = lmc_chain_at(rhs, ny, nx);
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
  v = lmc_chain_at(v, ny, nx);
  ey = lmc_chain_at(ey, ny, nx);
  ex = lmc_chain_at(ex, ny, nx);
  rhs = lmc_chain_at(rhs, ny, nx);
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
  u_in = lmc_chain_at(u_in, ny, nx);
  gu = lmc_chain_at(gu, ny, nx);
  rhs = lmc_chain_at(rhs, ny, nx);
  d = lmc_chain_at(d, ny, nx);
  u_out = lmc_chain_at(u_out, ny, nx);
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
  const uint32_t* chains;  // device, a word per chain; null: chain
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
  x = lmc_chain_at(x, ny, nx);
  u = lmc_chain_at(u, ny, nx);
  xbar = lmc_chain_at(xbar, ny, nx);
  mean = lmc_chain_at(mean, ny, nx);
  m2 = lmc_chain_at(m2, ny, nx);
  const float xo = x[k];
  float xn = u[k];
  if (f.with_noise) {
    const uint32_t chain = f.chains ? f.chains[blockIdx.z] : f.chain;
    xn = xn + f.noise_amp * lmc_normal(f.seed, chain, (uint32_t)k, f.step);
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
  xbar = lmc_chain_at(xbar, ny, nx);
  py = lmc_chain_at(py, ny, nx);
  px = lmc_chain_at(px, ny, nx);
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

// --- the resident route ------------------------------------------------------

// 32 warps, one CTA an SM
#define UL_RS_THREADS 1024

// Tile fields of the resident route (X, V, D, T, G, and the FGP point with
// the FGP envelope) and its dynamic shared memory: the tile fields, the
// interior's mean and m2, the gr/gc indices
// (kernels/ulpda_fused.py::ulpda_resident_plan).
__host__ __device__ inline int ul_rs_fields(int mode, int fgp) {
  return mode == MODE_METV && fgp ? 7 : 5;
}
static inline size_t ul_rs_smem(int ty, int tx, int h, int fields) {
  const size_t sy = ty + 2 * h, sx = tx + 2 * h;
  return sizeof(float) * (fields * sy * sx + 2 * (size_t)ty * tx) +
         sizeof(int) * (sy + sx);
}

// The resident route: n_steps ULPDA steps, x from xs[0] (step i reads
// xs[i % 2] and writes xs[1 - i % 2]), the dual (py, px) and xbar in place;
// with env_warm the envelope dual through ev[0..3] ((y, x) planes of parity
// 0, then 1), from zeros at the first step; u after sweep k through
// ub[k % 2] ((ny, nx) planes), a grid barrier after each but the last. Fields
// other CTAs write in this launch are read at L2 (__ldcg) and are not
// __restrict__. Grid layer z runs chain z of the launch: its x, dual, xbar,
// mean and m2 lie z ny nx floats past the pointers, its envelope duals z 8
// planes and its u planes z 2 planes (chain-major), its noise under
// chains[z] (null: sc.chain); the chains share atb, and the grid barriers
// step them together.
__global__ void __launch_bounds__(UL_RS_THREADS, 1)
ul_resident_block(float* x0, float* x1, float* py, float* px, float* xbar,
                  const float* __restrict__ atb, float* __restrict__ mean,
                  float* __restrict__ m2, float* ev, float* ub,
                  const uint32_t* chains, int ny, int nx, int n_steps,
                  int gfirst, int env_warm, UlpdaTile p, Sched sc) {
  namespace cg = cooperative_groups;
  extern __shared__ float sm[];
  __shared__ float fgp_coef[LMC_MAXTRIP];
  __shared__ float cheb[LMC_MAXTRIP][2];
  const int n = (p.ty + 2 * p.h) * (p.tx + 2 * p.h);
  const int ni = p.ty * p.tx;
  float* X = sm;
  float* V = X + n;
  float* D = V + n;
  float* T = D + n;
  float* G = T + n;
  float* RY = G + n;  // the FGP envelope only
  float* RX = RY + n;
  float* MU = sm + ul_rs_fields(p.mode, p.fgp) * n;
  float* M2 = MU + ni;
  const TileGeo t = lmc_tile_geo((int*)(M2 + ni), ny, nx, p.ty, p.tx, p.h);
  const size_t npix = (size_t)ny * nx;
  const size_t z = blockIdx.z;
  x0 += z * npix;
  x1 += z * npix;
  py += z * npix;
  px += z * npix;
  xbar += z * npix;
  if (sc.with_stats) {
    mean += z * npix;
    m2 += z * npix;
  }
  if (ev) ev += z * 8 * npix;
  ub += z * 2 * npix;
  const uint32_t chain = chains ? chains[z] : sc.chain;
  for (int i = threadIdx.x; i < LMC_MAXTRIP; i += blockDim.x) {
    fgp_coef[i] = p.fgp_coef[i];
    cheb[i][0] = p.cheb[i][0];
    cheb[i][1] = p.cheb[i][1];
  }
  if (sc.with_stats) {
    for (int li = threadIdx.x; li < ni; li += blockDim.x) {
      int lt, r, c;
      size_t k;
      if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
      MU[li] = mean[k];
      M2[li] = m2[k];
    }
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  // y <- proj(y + mu G xbar) on the interior (ul_dual)
  auto dual_phase = [&]() {
    for (int li = threadIdx.x; li < ni; li += blockDim.x) {
      int lt, r, c;
      size_t k;
      if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
      const float xb = __ldcg(xbar + k);
      const float gy = t.gr[r] < ny - 1 ? __ldcg(xbar + k + nx) - xb : 0.0f;
      const float gx = t.gc[c] < nx - 1 ? __ldcg(xbar + k + 1) - xb : 0.0f;
      lmc_project_dual(__ldcg(py + k) + p.mu * gy, __ldcg(px + k) + p.mu * gx,
                       p.g_sigma, p.l21, &py[k], &px[k]);
    }
  };

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
    const int par = it & 1;
    const float* src = par ? x1 : x0;
    float* dst = par ? x0 : x1;
    if (gfirst) {
      dual_phase();
      grid.sync();
    }
    const float* ein = env_warm && it > 0 ? ev + (size_t)(2 * (1 - par)) * npix : nullptr;
    float* eout = env_warm ? ev + (size_t)(2 * par) * npix : nullptr;
    // after a sweep: u of the interior out, a barrier, u on the interior
    // grown by reach in
    auto xch = [&](int sw) {
      float* u = ub + (size_t)(sw & 1) * npix;
      for (int li = threadIdx.x; li < ni; li += blockDim.x) {
        int lt, r, c;
        size_t k;
        if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
        u[k] = X[lt];
      }
      grid.sync();
      rs_rect(rs_grown(t, p.reach), t.sx, [&](int li, int r, int c) {
        X[li] = __ldcg(u + lmc_tile_k(r, c, t));
      });
      __syncthreads();
    };
    ul_primal_cone<false>(p, src, py, px, atb, ein, ein ? ein + npix : nullptr,
                          eout, X, V, D, T, G, RY, RX, fgp_coef, cheb, t, xch);
    // (4) x' = u + noise, xbar = x' + theta (x' - x), Welford (ul_finish)
    const StepW sw = lmc_step_w(sc, g);
    for (int li = threadIdx.x; li < ni; li += blockDim.x) {
      int lt, r, c;
      size_t k;
      if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
      const float xo = __ldcg(src + k);
      float xn = X[lt];
      if (sc.with_noise) {
        xn = xn + p.noise_amp * lmc_normal(sc.seed, chain, (uint32_t)k, (uint32_t)g);
      }
      dst[k] = xn;
      xbar[k] = xn + p.theta * (xn - xo);
      if (sc.with_stats) lmc_welford(xn, &MU[li], &M2[li], sw);
    }
    // x' and xbar are read next (the dual phase, the next primal phase)
    if (!gfirst) {
      grid.sync();
      dual_phase();
    }
    if (it + 1 < n_steps) grid.sync();
  }
  if (!sc.with_stats) return;
  for (int li = threadIdx.x; li < ni; li += blockDim.x) {
    int lt, r, c;
    size_t k;
    if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
    mean[k] = MU[li];
    m2[k] = M2[li];
  }
}

// The resident launches on interiors ty x tx, per chains a launch (the
// caller's plan), one a group of chains in turn. Returns a cudaError_t, or
// -1 when the tile does not fit the card's shared memory or the tiles of a
// launch are not all resident at once.
static int ul_resident_launch(float* x, float* parity, float* py, float* px,
                              float* xbar, const float* atb, float* mean,
                              float* m2, float* aux, float* ub,
                              const uint32_t* chains, int n_chains, int per,
                              int ny, int nx, UlpdaTile& p, int n_steps, int gfirst,
                              int env_warm, int with_noise, int with_stats,
                              unsigned int seed, unsigned int chain,
                              long long step0, long long burn, long long cnt0,
                              cudaStream_t s) {
  int dev = 0, n_sm = 0, optin = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ul_rs_smem(p.ty, p.tx, p.h, ul_rs_fields(p.mode, p.fgp));
  if (!coop || smem + sizeof(float) * 3 * LMC_MAXTRIP > (size_t)optin) return -1;
  e = cudaFuncSetAttribute(ul_resident_block,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ul_resident_block,
                                                      UL_RS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nx + p.tx - 1) / p.tx, (ny + p.ty - 1) / p.ty, per);
  if ((long long)per_sm * n_sm < (long long)grid.x * grid.y * grid.z) return -1;
  Sched sc;
  sc.step0 = step0;
  sc.burn = burn;
  sc.cnt0 = cnt0;
  sc.thin = 1;
  sc.n_q = 0;
  sc.with_noise = with_noise;
  sc.with_stats = with_stats;
  sc.seed = seed;
  sc.chain = chain;
  sc.chains = nullptr;  // the chain words ride as an argument
  float* ev = env_warm && p.mode == MODE_METV ? aux : nullptr;
  int warm = ev != nullptr;
  const size_t npix = (size_t)ny * nx;
  for (int c0 = 0; c0 < n_chains; c0 += per) {
    // the group's first chain: each pointer offset as the kernel offsets z
    float* gx = x + c0 * npix;
    float* gpar = parity + c0 * npix;
    float* gpy = py + c0 * npix;
    float* gpx = px + c0 * npix;
    float* gxb = xbar + c0 * npix;
    float* gmean = with_stats ? mean + c0 * npix : nullptr;
    float* gm2 = with_stats ? m2 + c0 * npix : nullptr;
    float* gev = ev ? ev + c0 * 8 * npix : nullptr;
    float* gub = ub + c0 * 2 * npix;
    const uint32_t* gch = chains ? chains + c0 : nullptr;
    dim3 gg = grid;
    gg.z = n_chains - c0 < per ? n_chains - c0 : per;
    void* args[] = {&gx, &gpar, &gpy, &gpx, &gxb, (void*)&atb, &gmean, &gm2, &gev,
                    &gub, (void*)&gch, &ny, &nx, &n_steps, &gfirst, &warm, &p, &sc};
    e = cudaLaunchCooperativeKernel((const void*)ul_resident_block, gg,
                                    dim3(UL_RS_THREADS), args, smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One call runs n_steps ULPDA steps of n_chains chains of one posterior in
// place on x, py, px, xbar, mean, m2, each (n_chains, ny, nx) (float32,
// row-major, contiguous, on the current device). The chains share atb
// (ny, nx); chain c draws its noise under (seed, chains[c]) (device,
// n_chains words), or (seed, chain) when chains is null (one chain). The
// wl1 dual takes one chain.
//   dual: 0 l1, 1 l21 (the Gradient2D dual (py, px)), 2 wl1 (py the
//   interleaved Haar coefficient dual of levels levels, px unused; each CTA
//   of its launches owns an rh x rw region of whole tiles, or, with
//   rh = rw = 0, one launch per level and axis with u and d as the
//   ping-pong buffers).
//   atb: A^T b (unscaled). With gfirst = 0 the incoming xbar is never read;
//   the outgoing one is the genuine x' + theta (x' - x) in both orders.
//   scratch, each (n_chains, ny, nx): v, rhs, u, d, gu; tmp: (rank,
//   n_chains, ny, nx); aux: (8 n_chains, ny, nx) in mode metv (envelope
//   duals), (2 n_chains, ny, nx) in mode mctv (the clamped gradient), null
//   in mode tv. The launch sequence holds the multi-plane scratch
//   plane-major (plane p of chain c at (p n_chains + c) ny nx).
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
// ty, tx: the resident route's interior (ty > 0; a Gradient2D dual, at most
// LMC_MAXTRIP sweeps and envelope trips, n_steps >= 1), per: the chains a
// resident launch carries (the launches run the groups in turn). Its final x
// is in x when n_steps is even and in parity ((n_chains, ny, nx) scratch)
// when it is odd; it reads none of v, rhs, u, d, gu, tmp and, in mode metv
// with env_warm, takes the first 4 of each chain's 8 planes of aux
// (chain-major) for the envelope dual, and exchanges u between the sweeps
// through ub ((n_chains, 2, ny, nx) scratch). 0 for the launch sequence.
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the supported range or a resident tile that does not fit the card.
extern "C" int lmc_ulpda_block(
    float* x, float* parity, float* py, float* px, float* xbar,
    const float* atb, float* mean, float* m2, float* v, float* rhs, float* u,
    float* d, float* gu, float* tmp, float* aux, int ny, int nx, int n_chains,
    const unsigned int* chains,
    const float* taps, int rank, int ky, int kx, int oy, int ox, int n_steps,
    int niter_solve, const float* cheb, int gfirst, int dual, int levels,
    int rh, int rw, int mode, int niter_inner, float tv_step, int fgp,
    const float* fgp_coef, int env_warm, int with_noise, int with_stats,
    const float* coef, unsigned int seed, unsigned int chain, long long step0,
    long long burn, long long cnt0, int ty, int tx, int per, float* ub,
    void* stream) {
  Taps t;
  if (!lmc_taps(&t, taps, rank, ky, kx, oy, ox) || ny < 2 || nx < 2 ||
      niter_solve < 0 || mode < MODE_TV || mode > MODE_METV ||
      (mode != MODE_TV && aux == nullptr) || dual < DUAL_L1 ||
      dual > DUAL_WL1 || (dual != DUAL_WL1 && px == nullptr) ||
      (dual == DUAL_WL1 && (rh > 0 || rw > 0) &&
       !lmc_region_ok(ny, nx, rh, rw, levels)) ||
      (dual == DUAL_WL1 && rh == 0 && rw == 0 && levels < 1) || n_chains < 1 ||
      n_chains > 65535 || (n_chains > 1 && (chains == nullptr || dual == DUAL_WL1)))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ty > 0) {
    if (tx < 1 || dual == DUAL_WL1 || n_steps < 1 || niter_solve > LMC_MAXTRIP ||
        niter_inner < 0 || niter_inner > LMC_MAXTRIP || ub == nullptr || per < 1)
      return -1;
    UlpdaTile p;
    p.tau = coef[0];
    p.mu = coef[1];
    p.theta = coef[2];
    p.noise_amp = coef[3];
    p.ts = coef[4];
    p.g_sigma = coef[5];
    p.c_mc = coef[6];
    p.gamma_mc = coef[7];
    p.clamp_mc = coef[8];
    p.c_me = coef[9];
    // x / gamma as x * (1 / gamma), as the launch sequence
    p.inv_gamma_mc = 1.0f / coef[7];
    p.tv_step = tv_step;
    p.niter_solve = niter_solve;
    p.mode = mode;
    p.niter_inner = niter_inner;
    p.fgp = fgp;
    p.l21 = dual == DUAL_L21;
    p.ty = ty;
    p.tx = tx;
    const int ry = lmc_taps_reach_y(t), rx = lmc_taps_reach_x(t);
    p.ry = ry;
    p.reach = ry > rx ? ry : rx;
    p.grow = 0;  // split sweeps
    p.h = ul_halo(p.reach, p.grow, niter_solve, mode, niter_inner);
    ul_tap_lists(&p, t, tx + 2 * p.h);
    for (int i = 0; i < LMC_MAXTRIP; ++i) {
      p.cheb[i][0] = i < niter_solve ? cheb[2 * i] : 0.0f;
      p.cheb[i][1] = i < niter_solve ? cheb[2 * i + 1] : 0.0f;
      p.fgp_coef[i] = fgp && mode == MODE_METV && i < niter_inner ? fgp_coef[i] : 0.0f;
    }
    return ul_resident_launch(x, parity, py, px, xbar, atb, mean, m2, aux, ub,
                              chains, n_chains, per, ny, nx, p, n_steps, gfirst,
                              env_warm, with_noise,
                              with_stats, seed, chain, step0, burn, cnt0, s);
  }
  const dim3 grid = lmc_grid(ny, nx, n_chains), block = lmc_block();
  // a plane of the plane-major scratch: every chain's copy of it
  const size_t plane = (size_t)ny * nx * n_chains;

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
  f.chains = chains;

  const DualBufs envb = lmc_dual_bufs(aux, plane);
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
        blk_mctv_clamp<<<grid, block, 0, s>>>(v, aux, aux + plane, ny, nx,
                                              clamp_mc);
        ul_mctv_rhs<<<grid, block, 0, s>>>(v, aux, aux + plane, atb, rhs, ny,
                                           nx, c_mc, ts);
      } else {
        cur_env = lmc_tv_trips(v, envb, env_warm ? cur_env : -1, niter_inner,
                               fgp, tv_step, fgp_coef, inv_gamma_mc, ny, nx, s,
                               n_chains);
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
