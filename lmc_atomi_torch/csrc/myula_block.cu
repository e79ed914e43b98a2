// Kernel 2: n_steps fused MYULA steps on the TV-deblurring posterior, with
// streaming Welford moments and P^2 quantile markers, for the plain L2 data
// term (mode tv) and the nonconvex MC-TV and ME-TV data terms.
//
// Replaces lmc_atomi_tpu/kernels/myula_fused.py::myula_tv_block_update
// (_block_kernel), which runs a whole block of steps inside one TPU core with
// every field resident in VMEM. Hopper has no 128 MiB scratch, but at 512^2 a
// chain's state fits the shared memory of the card's SMs taken together. So
// the host call picks one of two routes from the shape, the mode and the card
// (rs_plan), before any launch:
//
// Resident route (rs_myula_block): one cooperative launch runs the whole
// call, one CTA per 2-D tile of the image, every CTA resident at once (the
// tile geometry minimises the tile's area over tilings of at most one CTA an
// SM; kernels/myula_fused.py::resident_plan is the same rule). A CTA keeps its
// interior's atbs, mean and m2 in shared memory for the call and writes mean
// and m2 back once at the end. Per step it reads its tile of x, interior
// T_y x T_x plus a halo h in rows and columns, from one of two parity buffers
// (with tv_warm also the TV dual, and in mode metv the envelope dual, from
// their parity buffers), computes kernel 6's tile step in shared memory (the
// gram, the MC-TV clamp or the ME-TV envelope trips, the Chambolle or FGP
// trips, from the loaded duals when warm) on only the pixels its interior's
// result depends on (rs_trips, rs_gram), writes its interior's x (and duals)
// to the other buffers, runs the update, the Philox normal at the global
// pixel and step, Welford in shared memory and P^2 in global memory, and
// waits at one grid barrier. At 512^2 the exchange stays in the 50 MB L2; the
// step is bound by instruction issue in the TV trips (two passes a trip, the
// IEEE square root and division of each pixel's update, on a cone from 2.1x
// the interior down to 1.1x at h = niter_tv + 1), then the gram and the
// update; the grid barrier is ~1 us of a ~40 us cold-10 step (H100).
//
// Launch sequence (tiles that do not fit co-resident, 2048^2 and up): the
// fields stay in global memory and the host issues, for each step
// g = step0 + i:
//   (a) two separable wrap-convolution passes, grad = sigma A^T A x - sigma A^T b
//       with A^T A = sum_r wy_r wx_r^T (row pass, then column pass);
//   (a') mctv: one launch of the clamped gradient min(1/gamma, 1/|Gx|) Gx;
//       metv: niter_inner dual trips of the envelope prox at gamma_mc;
//   (b) niter_tv dual trips, Chambolle or FGP, ping-ponged between buffers
//       (with tv_warm the dual carries across the steps of one call and starts
//       from zeros at each call, as on the TPU);
//   (c) one elementwise launch: the mode's correction of the gradient (it
//       reads the divergence of (a')), x - gamma div p, the MYULA update, the
//       Philox normal at (seed, chain, pixel, g), burn-in-masked Welford, P^2.
// Each launch is bound by device-memory bytes and launch latency: a cold-10
// step is 13 launches. At 2048^2 it is the whole-image yardstick of kernel 6.
//
// Chains: a call runs n_chains chains of one posterior (multichain sampling,
// kernels/myula_fused.py::run_myula_tv_fused_packed), each with its own x,
// moments, markers and Philox chain word, all sharing atbs. The launch
// sequence takes them as a grid axis (blockIdx.z, lmc_chain_at); the
// resident route runs them in groups of G (rs_geometry: the launches in turn
// times the tile area is least), one cooperative launch a group, grid layer
// z of a launch a chain. At 64^2, 64 chains fill 128 SMs in one launch.
//
// Both routes take every pixel through the same float operations in the same
// order, so they equal the plain version bit for bit (chip_smoke.py checks it).
#include <cooperative_groups.h>

#include "block_common.cuh"

namespace {

struct UpdateParams {
  float c_keep, c_grad, c_prox, noise_amp, tv_gamma;
  float lamda, gamma_mc, c_env;  // nonconvex modes: lamda, gamma, lamda/gamma
  float w, inv_denom;
  int mode, with_noise, with_stats, n_q, c_prev;
  int q_all;  // the quantiles a chain's markers hold (n_q is 0 off a record)
  uint32_t seed, chain, step;
  const uint32_t* chains;  // device, a word per chain; null: chain
  float qcoef[LMC_MAXQ][3];
};

// (c): the nonconvex correction of the data gradient, prox, MYULA update,
// noise, Welford and P^2, in place on x/mean/m2/qh/qn. (ay, ax) is the MC-TV
// clamped gradient of x (mode mctv) or the ME-TV envelope dual (mode metv).
// Grid layer z is chain z (lmc_chain_at); its markers lie at z (5 + 3) q_all
// planes, chain-major as the caller holds them.
__global__ void blk_update(float* __restrict__ x, const float* __restrict__ grad,
                           const float* __restrict__ py,
                           const float* __restrict__ px,
                           const float* __restrict__ ay,
                           const float* __restrict__ ax,
                           float* __restrict__ mean, float* __restrict__ m2,
                           float* __restrict__ qh, float* __restrict__ qn,
                           int ny, int nx, UpdateParams u) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const size_t npix = (size_t)ny * nx;
  x = lmc_chain_at(x, ny, nx);
  grad = lmc_chain_at(grad, ny, nx);
  py = lmc_chain_at(py, ny, nx);
  px = lmc_chain_at(px, ny, nx);
  ay = lmc_chain_at(ay, ny, nx);
  ax = lmc_chain_at(ax, ny, nx);
  mean = lmc_chain_at(mean, ny, nx);
  m2 = lmc_chain_at(m2, ny, nx);
  if (u.n_q) {
    qh += (size_t)blockIdx.z * 5 * u.q_all * npix;
    qn += (size_t)blockIdx.z * 3 * u.q_all * npix;
  }
  const uint32_t chain = u.chains ? u.chains[blockIdx.z] : u.chain;
  const float xv = x[k];
  float g = grad[k];
  if (u.mode == MODE_MCTV) {
    // grad f -= lamda G^T(clamp G x), G^T = -div
    g = g + u.lamda * lmc_div(ay, ax, i, j, ny, nx);
  } else if (u.mode == MODE_METV) {
    // grad f -= lamda (x - prox_{gamma TV} x) / gamma
    const float env = xv - u.gamma_mc * lmc_div(ay, ax, i, j, ny, nx);
    g = g - u.c_env * (xv - env);
  }
  const float prox = xv - u.tv_gamma * lmc_div(py, px, i, j, ny, nx);
  float xn = u.c_keep * xv - u.c_grad * g + u.c_prox * prox;
  if (u.with_noise) {
    xn = xn + u.noise_amp * lmc_normal(u.seed, chain, (uint32_t)k, u.step);
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

// --- the resident route ------------------------------------------------------

// 32 warps, one CTA an SM
#define RS_THREADS 1024

struct ResidentParams {
  Taps taps;
  float c_keep, c_grad, c_prox, noise_amp, sigma, tv_gamma;
  float lamda, gamma_mc, clamp_mc, c_env, inv_tv_gamma, inv_gamma_mc, tv_step;
  int niter_tv, niter_inner, fgp, mode, tv_warm, n_steps, ty, tx, h;
  int ry;  // the row taps' reach
  float fgp_coef[LMC_MAXTRIP];
};

// Fields of a tile (x, u, the gram, the dual, the FGP point) and of the
// interior (atbs, mean, m2), in floats, and the gr/gc indices.
__host__ __device__ inline int rs_tile_fields(int fgp) { return fgp ? 7 : 5; }

static inline size_t rs_smem_bytes(int ty, int tx, int h, int fgp) {
  const size_t sy = ty + 2 * h, sx = tx + 2 * h;
  return sizeof(float) * (rs_tile_fields(fgp) * sy * sx + 3 * (size_t)ty * tx) +
         sizeof(int) * (sy + sx);
}

// The resident route: n_steps MYULA steps, x from xs[0] (step i reads xs[i %
// 2] and writes xs[1 - i % 2]); with tv_warm the TV dual through dv[0..3] and
// the ME-TV envelope dual through ev[0..3] the same way ((y, x) planes of
// parity 0, then 1), from zeros at the first step. The x, dual and marker
// buffers are read after other CTAs wrote them in this launch, so they are
// not __restrict__ (no read-only cache). Grid layer z runs chain z of the
// launch: its x, mean, m2 lie z ny nx floats past the pointers, its markers
// z (5 + 3) n_q planes (chain-major), its duals z 8 planes (chain-major,
// 8 planes a chain), its noise under chains[z] (null: sc.chain); the
// chains share atbs, and one grid barrier steps them together.
__global__ void __launch_bounds__(RS_THREADS, 1)
rs_myula_block(float* x0, float* x1, const float* __restrict__ atbs,
               float* __restrict__ mean, float* __restrict__ m2, float* qh,
               float* qn, float* dv, float* ev, const uint32_t* chains,
               int ny, int nx, ResidentParams p, Sched sc) {
  namespace cg = cooperative_groups;
  extern __shared__ float sm[];
  __shared__ float fgp_coef[LMC_MAXTRIP];
  const int n = (p.ty + 2 * p.h) * (p.tx + 2 * p.h);
  const int ni = p.ty * p.tx;
  float* X = sm;
  float* U = X + n;
  float* G = U + n;
  float* PY = G + n;
  float* PX = PY + n;
  float* RY = PX + n;  // FGP only
  float* RX = RY + n;
  float* A = sm + rs_tile_fields(p.fgp) * n;  // the interior's atbs
  float* MU = A + ni;
  float* M2 = MU + ni;
  const TileGeo t = lmc_tile_geo((int*)(M2 + ni), ny, nx, p.ty, p.tx, p.h);
  const size_t npix = (size_t)ny * nx;
  const size_t z = blockIdx.z;
  x0 += z * npix;
  x1 += z * npix;
  if (sc.with_stats) {
    mean += z * npix;
    m2 += z * npix;
  }
  if (sc.n_q) {
    qh += z * 5 * sc.n_q * npix;
    qn += z * 3 * sc.n_q * npix;
  }
  if (dv) dv += z * 8 * npix;
  if (ev) ev += z * 8 * npix;
  const uint32_t chain = chains ? chains[z] : sc.chain;
  for (int i = threadIdx.x; i < LMC_MAXTRIP; i += blockDim.x)
    fgp_coef[i] = p.fgp_coef[i];
  for (int li = threadIdx.x; li < ni; li += blockDim.x) {
    int lt, r, c;
    size_t k;
    if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
    A[li] = atbs[k];
    if (sc.with_stats) {
      MU[li] = mean[k];
      M2[li] = m2[k];
    }
  }
  __syncthreads();
  const bool warm_env = p.tv_warm && p.mode == MODE_METV;
  cg::grid_group grid = cg::this_grid();

  for (int it = 0; it < p.n_steps; ++it) {
    const long long g = sc.step0 + it;
    const int par = it & 1;
    const float* src = par ? x1 : x0;
    float* dst = par ? x0 : x1;
    // loads of what other CTAs wrote in this launch go to L2 (__ldcg)
    LMC_TILE_LOOP(t, li, r, c) X[li] = __ldcg(src + lmc_tile_k(r, c, t));
    __syncthreads();
    rs_gram(X, U, G, p.taps, t, p.ry);

    if (p.mode == MODE_MCTV) {
      // the clamped gradient min(1/gamma, 1/|G x|) G x (blk_mctv_clamp) where
      // its divergence on the interior reads it
      rs_rect(rs_grown(t, 1), t.sx, [&](int li, int r, int c) {
        float gy, gx;
        lmc_tile_fwd(X, li, r, c, t, &gy, &gx);
        float mag = sqrtf(gy * gy + gx * gx);
        mag = (mag != 0.0f) ? mag : 1e-9f;
        const float clamp = fminf(1.0f / mag, p.clamp_mc);
        PY[li] = clamp * gy;
        PX[li] = clamp * gx;
      });
      __syncthreads();
    } else if (p.mode == MODE_METV) {
      const float* e = warm_env && it > 0 ? ev + (size_t)(2 * (1 - par)) * npix : nullptr;
      rs_trips(p, X, U, PY, PX, RY, RX, e, e ? e + npix : nullptr, p.inv_gamma_mc,
               p.niter_inner, fgp_coef, t);
    }
    // the data gradient and the mode's correction on the interior
    // (blk_colconv, then blk_update's order); a warm envelope dual goes out
    float* eo = warm_env ? ev + (size_t)(2 * par) * npix : nullptr;
    for (int li = threadIdx.x; li < ni; li += blockDim.x) {
      int lt, r, c;
      size_t k;
      if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
      float gv = p.sigma * G[lt] - A[li];
      if (p.mode == MODE_MCTV) {
        gv = gv + p.lamda * lmc_tile_div(PY, PX, lt, r, c, t);
      } else if (p.mode == MODE_METV) {
        const float xv = X[lt];
        const float env = xv - p.gamma_mc * lmc_tile_div(PY, PX, lt, r, c, t);
        gv = gv - p.c_env * (xv - env);
        if (eo != nullptr) {
          eo[k] = PY[lt];
          eo[npix + k] = PX[lt];
        }
      }
      G[lt] = gv;
    }
    __syncthreads();
    const float* d = p.tv_warm && it > 0 ? dv + (size_t)(2 * (1 - par)) * npix : nullptr;
    rs_trips(p, X, U, PY, PX, RY, RX, d, d ? d + npix : nullptr, p.inv_tv_gamma,
             p.niter_tv, fgp_coef, t);

    float* dout = p.tv_warm ? dv + (size_t)(2 * par) * npix : nullptr;
    const StepW sw = lmc_step_w(sc, g);
    for (int li = threadIdx.x; li < ni; li += blockDim.x) {
      int lt, r, c;
      size_t k;
      if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
      const float xv = X[lt];
      const float prox = xv - p.tv_gamma * lmc_tile_div(PY, PX, lt, r, c, t);
      float xn = p.c_keep * xv - p.c_grad * G[lt] + p.c_prox * prox;
      if (sc.with_noise) {
        xn = xn + p.noise_amp * lmc_normal(sc.seed, chain, (uint32_t)k, (uint32_t)g);
      }
      dst[k] = xn;
      if (dout != nullptr) {
        dout[k] = PY[lt];
        dout[npix + k] = PX[lt];
      }
      if (sc.with_stats) lmc_welford(xn, &MU[li], &M2[li], sw);
      lmc_p2_global(xn, k, npix, qh, qn, sc, sw);
    }
    // the tile's buffers are rewritten and the other CTAs' writes read next
    if (it + 1 < p.n_steps) grid.sync();
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

// The resident route's geometry (for at most LMC_MAXTRIP trips of either
// prox and at least one step): the halo h (kernel 6's), and the interior
// T_y x T_x (multiples of 8) whose tiles number at most n_sm and whose shared
// memory (with the static fgp_coef) fits smem_optin, with G = min(n_chains,
// n_sm / tiles) chains a launch, that costs the least: launches in turn
// (ceil(n_chains / G)) x tile area (T_y + 2h)(T_x + 2h), the work of the
// busiest CTA (one chain: the least tile area); the first such in (T_y, T_x)
// order. Returns false when none fits.
static bool rs_geometry(int ny, int nx, const Taps& tp, int niter_tv,
                        int fgp, int mode, int niter_inner, int n_chains,
                        int n_sm, size_t smem_optin, int* ty, int* tx, int* h,
                        int* g, size_t* smem) {
  int hh = niter_tv + 1;
  hh = hh > lmc_taps_reach_y(tp) ? hh : lmc_taps_reach_y(tp);
  hh = hh > lmc_taps_reach_x(tp) ? hh : lmc_taps_reach_x(tp);
  if (mode == MODE_MCTV && hh < 2) hh = 2;
  if (mode == MODE_METV && hh < niter_inner + 1) hh = niter_inner + 1;
  long long best = -1;
  for (int a = 8; a < ny + 8; a += 8) {
    for (int b = 8; b < nx + 8; b += 8) {
      const long long count = (long long)((ny + a - 1) / a) * ((nx + b - 1) / b);
      const size_t bytes = rs_smem_bytes(a, b, hh, fgp);
      if (count > n_sm || bytes + sizeof(float) * LMC_MAXTRIP > smem_optin) continue;
      const long long per = n_sm / count < n_chains ? n_sm / count : n_chains;
      const long long cost =
          (n_chains + per - 1) / per * (long long)(a + 2 * hh) * (b + 2 * hh);
      if (best < 0 || cost < best) {
        best = cost;
        *ty = a;
        *tx = b;
        *g = (int)per;
        *smem = bytes;
      }
    }
  }
  *h = hh;
  return best >= 0;
}

// The route choice and, where the tiles fit co-resident on the card, the
// resident launches, one a group of G chains in turn; plan[0] stays 0 for
// the launch sequence. Returns a cudaError_t.
static int rs_launch(float* x, float* parity, const float* atbs, float* mean,
                     float* m2, float* qh, float* qn, float* duals, float* aux,
                     const uint32_t* chains, int n_chains,
                     int* plan, int ny, int nx, const Taps& tp, int n_steps,
                     int niter_tv, float tv_step, int fgp,
                     const float* fgp_coef, int tv_warm, int mode,
                     int niter_inner, int with_noise, int with_stats,
                     const float* qcoef, int n_q, int thin, const float* coef,
                     unsigned int seed, unsigned int chain, long long step0,
                     long long burn, long long cnt0, cudaStream_t s) {
  if (n_steps < 1 || niter_tv < 0 || niter_tv > LMC_MAXTRIP || niter_inner < 0 ||
      niter_inner > LMC_MAXTRIP)
    return 0;
  int dev = 0, n_sm = 0, optin = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  ResidentParams p;
  size_t smem = 0;
  int per = 1;
  if (!coop || !rs_geometry(ny, nx, tp, niter_tv, fgp, mode, niter_inner, n_chains,
                            n_sm, (size_t)optin, &p.ty, &p.tx, &p.h, &per, &smem))
    return 0;
  e = cudaFuncSetAttribute(rs_myula_block,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rs_myula_block,
                                                      RS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nx + p.tx - 1) / p.tx, (ny + p.ty - 1) / p.ty, per);
  if ((long long)per_sm * n_sm < (long long)grid.x * grid.y * grid.z) return 0;

  p.taps = tp;
  p.ry = lmc_taps_reach_y(tp);
  p.c_keep = coef[0];
  p.c_grad = coef[1];
  p.c_prox = coef[2];
  p.noise_amp = coef[3];
  p.sigma = coef[4];
  p.tv_gamma = coef[5];
  p.lamda = coef[6];
  p.gamma_mc = coef[7];
  p.clamp_mc = coef[8];
  p.c_env = coef[9];
  // x / gamma as x * (1 / gamma), as the launch sequence
  p.inv_tv_gamma = 1.0f / coef[5];
  p.inv_gamma_mc = 1.0f / coef[7];
  p.tv_step = tv_step;
  p.niter_tv = niter_tv;
  p.niter_inner = niter_inner;
  p.fgp = fgp;
  p.mode = mode;
  p.tv_warm = tv_warm;
  p.n_steps = n_steps;
  const int n_coef = niter_tv > (mode == MODE_METV ? niter_inner : 0)
                         ? niter_tv : (mode == MODE_METV ? niter_inner : 0);
  for (int i = 0; i < LMC_MAXTRIP; ++i) p.fgp_coef[i] = i < n_coef ? fgp_coef[i] : 0.0f;
  Sched sc;
  sc.step0 = step0;
  sc.burn = burn;
  sc.cnt0 = cnt0;
  sc.thin = thin;
  sc.n_q = n_q;
  sc.with_noise = with_noise;
  sc.with_stats = with_stats;
  sc.seed = seed;
  sc.chain = chain;
  sc.chains = nullptr;  // the chain words ride as an argument
  for (int jq = 0; jq < LMC_MAXQ; ++jq)
    for (int m = 0; m < 3; ++m) sc.qcoef[jq][m] = jq < n_q ? qcoef[3 * jq + m] : 0.0f;
  // the warm duals' parity buffers: (y, x) of parity 0, then 1
  float* dv = tv_warm ? duals : nullptr;
  float* ev = tv_warm && mode == MODE_METV ? aux : nullptr;
  const size_t npix = (size_t)ny * nx;
  for (int c0 = 0; c0 < n_chains; c0 += per) {
    // the group's first chain: each pointer offset as the kernel offsets z
    float* gx = x + c0 * npix;
    float* gpar = parity + c0 * npix;
    float* gmean = with_stats ? mean + c0 * npix : nullptr;
    float* gm2 = with_stats ? m2 + c0 * npix : nullptr;
    float* gqh = n_q ? qh + c0 * 5 * n_q * npix : nullptr;
    float* gqn = n_q ? qn + c0 * 3 * n_q * npix : nullptr;
    float* gdv = dv ? dv + c0 * 8 * npix : nullptr;
    float* gev = ev ? ev + c0 * 8 * npix : nullptr;
    const uint32_t* gch = chains ? chains + c0 : nullptr;
    dim3 gg = grid;
    gg.z = n_chains - c0 < per ? n_chains - c0 : per;
    void* args[] = {&gx, &gpar, (void*)&atbs, &gmean, &gm2, &gqh, &gqn, &gdv, &gev,
                    (void*)&gch, &ny, &nx, &p, &sc};
    e = cudaLaunchCooperativeKernel((const void*)rs_myula_block, gg,
                                    dim3(RS_THREADS), args, smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  plan[0] = 1;
  plan[1] = p.ty;
  plan[2] = p.tx;
  plan[3] = p.h;
  plan[4] = per;
  return (int)cudaGetLastError();
}

}  // namespace

// One call runs n_steps MYULA steps of n_chains chains of one posterior on
// x, mean, m2 (n_chains, ny, nx), qh (n_chains, 5 n_q, ny, nx), qn
// (n_chains, 3 n_q, ny, nx) (float32, row-major, contiguous, on the current
// device), in place but for x: the final x is in x after the launch
// sequence, and after the resident route in x when n_steps is even, in
// parity when it is odd. The chains share atbs (ny, nx); chain c draws its
// noise under (seed, chains[c]) (device, n_chains words), or (seed, chain)
// when chains is null (one chain).
//   parity, grad: (n_chains, ny, nx) scratch; tmp: (rank, n_chains, ny, nx)
//   scratch; duals: (8 n_chains, ny, nx) for the TV prox; aux: the same for
//   the ME-TV envelope prox, or (2 n_chains, ny, nx) for the MC-TV clamped
//   gradient (null in mode tv). The launch sequence holds the scratch
//   plane-major (plane p of chain c at (p n_chains + c) ny nx), the resident
//   route the duals and aux chain-major (c 8 + p).
//   taps: host, rank * (ky + kx) floats, for each rank wy then wx.
//   coef: host, 10 floats [1 - tau/gamma, tau, tau/gamma,
//         noise_scale * sqrt(2 tau), sigma, tv_gamma, lamda, gamma_mc,
//         1/gamma_mc, lamda/gamma_mc] (the last four unused in mode tv).
//   fgp_coef: host, max(niter_tv, niter_inner) floats (FGP momentum;
//         ignored for Chambolle).
//   qcoef: host, n_q * 3 floats (dn - 1) / 4 for the interior markers.
// The envelope prox runs niter_inner trips of the same solver as the TV
// prox; with tv_warm both duals carry across the steps of this call and
// start from zeros at each call, as on the TPU.
// plan: out, 5 ints: the route (1 resident, 0 the launch sequence), the
// resident tile's T_y, T_x and h, and the chains G a resident launch
// carries (0 for the sequence, whose launches carry every chain).
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the supported range.
extern "C" int lmc_myula_block(
    float* x, float* parity, const float* atbs, float* mean, float* m2,
    float* qh, float* qn, float* grad, float* tmp, float* duals, float* aux,
    int* plan, int ny, int nx, int n_chains, const unsigned int* chains,
    const float* taps, int rank, int ky, int kx, int oy, int ox, int n_steps,
    int niter_tv, float tv_step, int fgp, const float* fgp_coef, int tv_warm,
    int mode, int niter_inner, int with_noise, int with_stats,
    const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, void* stream) {
  Taps t;
  if (!lmc_taps(&t, taps, rank, ky, kx, oy, ox) || n_q < 0 || n_q > LMC_MAXQ ||
      thin < 1 || ny < 2 || nx < 2 || mode < MODE_TV || mode > MODE_METV ||
      (mode != MODE_TV && aux == nullptr) || n_chains < 1 || n_chains > 65535 ||
      (n_chains > 1 && chains == nullptr))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  plan[0] = plan[1] = plan[2] = plan[3] = plan[4] = 0;
  int e = rs_launch(x, parity, atbs, mean, m2, qh, qn, duals, aux, chains,
                    n_chains, plan, ny, nx, t, n_steps, niter_tv, tv_step, fgp,
                    fgp_coef, tv_warm, mode, niter_inner, with_noise, with_stats,
                    qcoef, n_q, thin, coef, seed, chain, step0, burn, cnt0, s);
  if (e != 0 || plan[0]) return e;
  const dim3 grid = lmc_grid(ny, nx, n_chains), block = lmc_block();
  const size_t npix = (size_t)ny * nx;
  // a plane of the plane-major scratch: every chain's copy of it
  const size_t plane = npix * n_chains;

  UpdateParams u;
  u.c_keep = coef[0];
  u.c_grad = coef[1];
  u.c_prox = coef[2];
  u.noise_amp = coef[3];
  u.tv_gamma = coef[5];
  u.lamda = coef[6];
  u.gamma_mc = coef[7];
  u.c_env = coef[9];
  u.mode = mode;
  u.with_noise = with_noise;
  u.with_stats = with_stats;
  u.seed = seed;
  u.chain = chain;
  u.chains = chains;
  u.q_all = n_q;
  for (int jq = 0; jq < n_q; ++jq)
    for (int m = 0; m < 3; ++m) u.qcoef[jq][m] = qcoef[3 * jq + m];
  const float sigma = coef[4];
  // x / gamma as x * (1 / gamma), the reciprocal of the float gamma, as torch
  // divides a CUDA tensor by a Python scalar
  const float inv_tv_gamma = 1.0f / coef[5];
  const float inv_gamma_mc = 1.0f / coef[7];
  const float clamp_mc = coef[8];

  const DualBufs tvb = lmc_dual_bufs(duals, plane);
  const DualBufs envb = lmc_dual_bufs(aux, plane);
  int cur = -1;      // index into tvb.P of the carried TV dual; -1 is zero
  int cur_env = -1;  // the same for the envelope dual

  for (int it = 0; it < n_steps; ++it) {
    const long long g = step0 + it;
    blk_rowconv<<<grid, block, 0, s>>>(x, tmp, ny, nx, t);
    blk_colconv<<<grid, block, 0, s>>>(tmp, atbs, grad, ny, nx, t, sigma);

    const float* ay = nullptr;
    const float* ax = nullptr;
    if (mode == MODE_MCTV) {
      blk_mctv_clamp<<<grid, block, 0, s>>>(x, aux, aux + plane, ny, nx,
                                            clamp_mc);
      ay = aux;
      ax = aux + plane;
    } else if (mode == MODE_METV) {
      cur_env = lmc_tv_trips(x, envb, tv_warm ? cur_env : -1, niter_inner,
                             fgp, tv_step, fgp_coef, inv_gamma_mc, ny, nx, s,
                             n_chains);
      ay = lmc_dual_y(envb, cur_env);
      ax = lmc_dual_x(envb, cur_env);
    }
    cur = lmc_tv_trips(x, tvb, tv_warm ? cur : -1, niter_tv, fgp, tv_step,
                       fgp_coef, inv_tv_gamma, ny, nx, s, n_chains);

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
    blk_update<<<grid, block, 0, s>>>(x, grad, lmc_dual_y(tvb, cur),
                                      lmc_dual_x(tvb, cur), ay, ax, mean, m2,
                                      qh, qn, ny, nx, u);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
