// Kernels 6 and 7: halo-tile kernels for large images, one CTA per 2-D
// tile of the image held in shared memory (block_common.cuh, "halo tiles").
//
// Kernel 6 replaces lmc_atomi_tpu/kernels/myula_tiled.py::myula_tv_tiled_update
// (_tiled_kernel), which runs MYULA steps over full-width row bands with a
// halo of rows, x and sigma A^T b resident in a TPU core's VMEM. Here one
// launch is one step: each CTA reads its tile of x (interior ty x tx, halo h
// in rows AND columns, since a band of full rows does not fit 227 KB of
// shared memory past ~1024 columns) and computes, all in shared memory, only
// what its interior's result reads (the cone of kernel 2's resident route,
// block_common.cuh: rs_gram, rs_trips): the separable gram on the interior,
// the MC-TV clamp on the interior grown by 1 or the ME-TV envelope trips,
// and the niter_tv cold Chambolle or FGP trips, trip tr on the interior grown
// by niter_tv - tr, with a barrier between the phases of a trip; it writes
// only its interior: the MYULA update, the Philox normal at the global pixel
// and step, weighted Welford and P^2. x ping-pongs between two global
// buffers (a tile reads its neighbours' halo of the previous step). A tile
// whose rows and columns avoid image row ny - 1 and column nx - 1 (all but
// the first and last row and column of tiles) runs the same step without the
// per-pixel mask lookups and tile-edge checks (kFree), decided once per CTA.
// Per step the kernel moves x in and out, atbs, mean and m2 in and out (and
// the markers on recorded steps) through device memory once, plus the halo
// rereads; at 2048^2 the 16.8 MB fields do not stay in the 50 MB L2 across
// the ten launches of a whole-image kernel-2 step, which is what this design
// avoids. It is bound by instruction issue in the TV trips (two passes a
// trip over the cone, the IEEE square root and division of each pixel's
// update) and their barriers. The host picks the interior and the CTA size
// (kernels/myula_tiled.py::tiled_plan) that minimise the grid's cone work per
// step, counted in waves over the card's SMs, within the shared memory of two
// CTAs of 512 threads or one of 1024 an SM.
//
// Kernel 7 replaces lmc_atomi_tpu/kernels/ulpda_tiled.py::ulpda_tv_tiled_update
// (_ulpda_tiled_kernel): two launches a step. The dual pass
// p <- proj(p + mu grad xbar) is row-local and runs one thread per pixel in
// place, xbar = x_new + theta (x_new - x_old) recomputed from the x parity
// pair. The primal pass is a halo tile on which each CTA computes only the
// cone its interior's result reads (kernel 3's resident route shares it,
// block_common.cuh: ul_primal_cone): v = x - tau A^T p on the interior grown
// by the Chebyshev sweeps' reach and the correction's depth, the MC-TV clamp
// or the cold ME-TV envelope trips, rhs = v + tau sigma A^T b, sweep k of
// the niter_solve Chebyshev sweeps on the interior grown by
// reach (niter_solve - 1 - k); then noise, Welford and P^2 on the interior.
// Edge-free tiles take kernel 6's mask-free instantiation, and the host
// picks the interior and the CTA size
// (kernels/ulpda_tiled.py::ulpda_tiled_plan) as it does for kernel 6. It is
// bound by instruction issue in the gram passes (and the envelope trips) on
// the cone, and by the Philox of the update.
//
// Chains: a call runs n_chains chains of one posterior (the "tiled" and
// "ulpda_tiled" chain farms), sharing atbs (atb), each launch carrying every
// chain as a grid layer (blockIdx.z: TL_LAYER, lmc_chain_at; x, its parity
// partner, the dual, the moments and the markers chain-major), as the TPU's
// jax.vmap of the pallas_call runs one kernel with a chain grid axis; the
// host planners count every chain's tiles in a launch's waves.
//
// Every interior pixel takes the operations of kernels 2 and 3 in their
// order, so the tile kernels equal them, and their plain versions, bit for
// bit (chip_smoke.py checks it), and a chain of a batched call its one-chain
// call. Kernel 8, one MYULA step given the data
// gradient, is kernel 1's tile kernel with an epilogue (tv_prox.cu).
#include "block_common.cuh"

namespace {

struct MyulaTile {
  Taps taps;
  float c_keep, c_grad, c_prox, noise_amp, sigma, tv_gamma;
  float lamda, gamma_mc, clamp_mc, c_env, inv_tv_gamma, inv_gamma_mc, tv_step;
  int niter_tv, niter_inner, fgp, mode, ty, tx, h;
  int ry;  // the row taps' reach
  float fgp_coef[LMC_MAXTRIP];
};

// Kernel 6's step on one CTA's tile, kFree on an edge-free tile: the gram
// on the interior into G (ty x tx), the MC-TV clamp on the interior grown by
// 1 or the cold ME-TV envelope trips, the data gradient and correction on
// the interior, the cold TV trips (each on its cone, rs_trips), then the
// update, noise, Welford and P^2 on the interior.
template <bool kFree>
__device__ __forceinline__ void tl_myula_tile(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ atbs, float* __restrict__ mean,
    float* __restrict__ m2, float* __restrict__ qh, float* __restrict__ qn,
    const MyulaTile& p, const Sched& sc, long long g, float* X, float* U,
    float* PY, float* PX, float* RY, float* RX, float* G,
    const float* fgp_coef, const TileGeo& t) {
  lmc_tile_load(X, src, t);
  __syncthreads();
  rs_gram<kFree, true>(X, U, G, p.taps, t, p.ry);
  if (p.mode == MODE_MCTV) {
    // the clamped gradient min(1/gamma, 1/|G x|) G x (blk_mctv_clamp) where
    // its divergence on the interior reads it
    rs_rect(rs_grown(t, 1), t.sx, [&](int li, int r, int c) {
      float gy, gx;
      lmc_tile_fwd<kFree>(X, li, r, c, t, &gy, &gx);
      float mag = sqrtf(gy * gy + gx * gx);
      mag = (mag != 0.0f) ? mag : 1e-9f;
      const float clamp = fminf(1.0f / mag, p.clamp_mc);
      PY[li] = clamp * gy;
      PX[li] = clamp * gx;
    });
    __syncthreads();
  } else if (p.mode == MODE_METV) {
    rs_trips<kFree>(p, X, U, PY, PX, RY, RX, nullptr, nullptr, p.inv_gamma_mc,
                    p.niter_inner, fgp_coef, t);
  }
  // the data gradient and the mode's correction on the interior (blk_colconv,
  // then blk_update's order)
  for (int li = threadIdx.x; li < t.ty * t.tx; li += blockDim.x) {
    int lt, r, c;
    size_t k;
    if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
    float gv = p.sigma * G[li] - atbs[k];
    if (p.mode == MODE_MCTV) {
      gv = gv + p.lamda * lmc_tile_div<kFree>(PY, PX, lt, r, c, t);
    } else if (p.mode == MODE_METV) {
      const float xv = X[lt];
      const float env = xv - p.gamma_mc * lmc_tile_div<kFree>(PY, PX, lt, r, c, t);
      gv = gv - p.c_env * (xv - env);
    }
    G[li] = gv;
  }
  __syncthreads();
  rs_trips<kFree>(p, X, U, PY, PX, RY, RX, nullptr, nullptr, p.inv_tv_gamma,
                  p.niter_tv, fgp_coef, t);

  const StepW sw = lmc_step_w(sc, g);
  const size_t npix = (size_t)t.ny * t.nx;
  for (int li = threadIdx.x; li < t.ty * t.tx; li += blockDim.x) {
    int lt, r, c;
    size_t k;
    if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
    const float xv = X[lt];
    const float prox = xv - p.tv_gamma * lmc_tile_div<kFree>(PY, PX, lt, r, c, t);
    float xn = p.c_keep * xv - p.c_grad * G[li] + p.c_prox * prox;
    if (sc.with_noise) {
      xn = xn + p.noise_amp * lmc_normal(sc.seed, lmc_sched_chain(sc),
                                         (uint32_t)k, (uint32_t)g);
    }
    dst[k] = xn;
    lmc_record_global(xn, k, npix, mean, m2, qh, qn, sc, sw);
  }
}

// Grid layer z runs chain z of the launch: src, dst, the moments and the
// markers move to its copies, ny nx floats and (5 + 3) n_q planes a chain
// (chain-major); the chains share atbs, and the chain's Philox word is
// lmc_sched_chain's. One layer is the one-chain launch.
#define TL_LAYER(npix, n_q)                        \
  src = lmc_layer(src, npix);                      \
  dst = lmc_layer(dst, npix);                      \
  mean = lmc_layer(mean, npix);                    \
  m2 = lmc_layer(m2, npix);                        \
  qh = lmc_layer(qh, 5 * (size_t)(n_q) * (npix));  \
  qn = lmc_layer(qn, 3 * (size_t)(n_q) * (npix))

// Kernel 6: MYULA step g from src into dst, Welford / P^2 in place, grid
// layer z for chain z (TL_LAYER). An SM runs 1024 threads of it (two CTAs of
// 512 or one of 1024), at most 64 registers a thread.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
tl_myula_step(const float* __restrict__ src, float* __restrict__ dst,
              const float* __restrict__ atbs, float* __restrict__ mean,
              float* __restrict__ m2, float* __restrict__ qh,
              float* __restrict__ qn, int ny, int nx, MyulaTile p, Sched sc,
              long long g) {
  extern __shared__ float sm[];
  TL_LAYER((size_t)ny * nx, sc.n_q);
  __shared__ float fgp_coef[LMC_MAXTRIP];
  const int n = (p.ty + 2 * p.h) * (p.tx + 2 * p.h);
  float* X = sm;
  float* U = X + n;
  float* PY = U + n;
  float* PX = PY + n;
  float* RY = PX + n;  // FGP only
  float* RX = RY + n;
  float* G = sm + (p.fgp ? 6 : 4) * n;  // the interior's gradient, ty x tx
  const TileGeo t = lmc_tile_geo((int*)(G + p.ty * p.tx), ny, nx, p.ty, p.tx,
                                 p.h);
  for (int i = threadIdx.x; i < LMC_MAXTRIP; i += blockDim.x)
    fgp_coef[i] = p.fgp_coef[i];
  __syncthreads();
  if (lmc_tile_free(t)) {
    tl_myula_tile<true>(src, dst, atbs, mean, m2, qh, qn, p, sc, g, X, U, PY,
                        PX, RY, RX, G, fgp_coef, t);
  } else {
    tl_myula_tile<false>(src, dst, atbs, mean, m2, qh, qn, p, sc, g, X, U, PY,
                         PX, RY, RX, G, fgp_coef, t);
  }
}

// Kernel 7's dual pass: p <- proj(p + mu grad xbar) in place, one thread per
// pixel, xbar = xn + theta (xn - xo) (ul_finish's form) at (i, j), (i+1, j)
// and (i, j+1); grid layer z for chain z (lmc_chain_at).
__global__ void tl_ulpda_dual(const float* __restrict__ xn,
                              const float* __restrict__ xo,
                              float* __restrict__ py, float* __restrict__ px,
                              int ny, int nx, float mu, float theta,
                              float g_sigma, int l21) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  xn = lmc_chain_at(xn, ny, nx);
  xo = lmc_chain_at(xo, ny, nx);
  py = lmc_chain_at(py, ny, nx);
  px = lmc_chain_at(px, ny, nx);
  const int k = i * nx + j;
  const float xb = xn[k] + theta * (xn[k] - xo[k]);
  float gy = 0.0f, gx = 0.0f;
  if (i < ny - 1) gy = (xn[k + nx] + theta * (xn[k + nx] - xo[k + nx])) - xb;
  if (j < nx - 1) gx = (xn[k + 1] + theta * (xn[k + 1] - xo[k + 1])) - xb;
  lmc_project_dual(py[k] + mu * gy, px[k] + mu * gx, g_sigma, l21, &py[k],
                   &px[k]);
}

// Kernel 7's primal pass: step g from src into dst, Welford / P^2 in place,
// on the cone of the tile's interior (ul_primal_cone), kFree on an edge-free
// tile; grid layer z for chain z (TL_LAYER, the dual a chain's (py, px)). An
// SM runs 1024 threads of it (two CTAs of 512 or one of 1024), at most 64
// registers a thread.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
tl_ulpda_primal(const float* __restrict__ src, float* __restrict__ dst,
                const float* __restrict__ py, const float* __restrict__ px,
                const float* __restrict__ atb, float* __restrict__ mean,
                float* __restrict__ m2, float* __restrict__ qh,
                float* __restrict__ qn, int ny, int nx, UlpdaTile p, Sched sc,
                long long g) {
  extern __shared__ float sm[];
  __shared__ float cheb[LMC_MAXTRIP][2];
  TL_LAYER((size_t)ny * nx, sc.n_q);
  py = lmc_chain_at(py, ny, nx);
  px = lmc_chain_at(px, ny, nx);
  const int n = (p.ty + 2 * p.h) * (p.tx + 2 * p.h);
  float* X = sm;  // x, then u
  float* V = X + n;
  float* D = V + n;
  float* T = D + n;
  float* G = T + n;
  const TileGeo t = lmc_tile_geo((int*)(sm + 5 * n), ny, nx, p.ty, p.tx, p.h);
  for (int i = threadIdx.x; i < LMC_MAXTRIP; i += blockDim.x) {
    cheb[i][0] = p.cheb[i][0];
    cheb[i][1] = p.cheb[i][1];
  }
  __syncthreads();
  if (lmc_tile_free(t)) {
    ul_primal_cone<true>(p, src, py, px, atb, nullptr, nullptr, nullptr, X, V,
                         D, T, G, nullptr, nullptr, nullptr, cheb, t,
                         [](int) {});
  } else {
    ul_primal_cone<false>(p, src, py, px, atb, nullptr, nullptr, nullptr, X, V,
                          D, T, G, nullptr, nullptr, nullptr, cheb, t,
                          [](int) {});
  }
  // (4) noise, Welford, P^2 on the interior (ul_finish)
  const StepW stw = lmc_step_w(sc, g);
  const size_t npix = (size_t)ny * nx;
  for (int li = threadIdx.x; li < p.ty * p.tx; li += blockDim.x) {
    int lt, r, c;
    size_t k;
    if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
    float xn = X[lt];
    if (sc.with_noise) {
      xn = xn + p.noise_amp * lmc_normal(sc.seed, lmc_sched_chain(sc),
                                         (uint32_t)k, (uint32_t)g);
    }
    dst[k] = xn;
    lmc_record_global(xn, k, npix, mean, m2, qh, qn, sc, stw);
  }
}

// Dynamic shared memory above 48 KB for kernel fn.
template <typename F>
int tl_smem(F fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

Sched tl_sched(int n_q, int thin, int with_noise, const float* qcoef,
               unsigned int seed, unsigned int chain, const unsigned int* chains,
               long long step0, long long burn, long long cnt0) {
  Sched sc;
  sc.step0 = step0;
  sc.burn = burn;
  sc.cnt0 = cnt0;
  sc.thin = thin;
  sc.n_q = n_q;
  sc.with_noise = with_noise;
  sc.with_stats = 1;
  sc.seed = seed;
  sc.chain = chain;
  sc.chains = chains;
  for (int jq = 0; jq < n_q; ++jq)
    for (int m = 0; m < 3; ++m) sc.qcoef[jq][m] = qcoef[3 * jq + m];
  return sc;
}

int tl_max(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of a kernel-6 CTA: x, u and the dual (with FGP also
// its point) on the tile, the gradient on the interior, the gr/gc indices.
size_t tl_smem_bytes(int ty, int tx, int h, int fgp) {
  const size_t sy = ty + 2 * h, sx = tx + 2 * h;
  return sizeof(float) * ((fgp ? 6 : 4) * sy * sx + (size_t)ty * tx) +
         sizeof(int) * (sy + sx);
}

}  // namespace

// Kernel 6: n_steps (even) MYULA steps of n_chains chains of one posterior
// on x (float32, row-major, contiguous, on the current device), Welford on
// mean/m2 and P^2 on qh/qn in place; x, mean, m2 (n_chains, ny, nx), qh
// (n_chains, 5 n_q, ny, nx), qn (n_chains, 3 n_q, ny, nx); parity:
// (n_chains, ny, nx) scratch for the other step parity. One launch a step
// carries every chain, grid layer z chain z; the chains share atbs, and
// chain c draws its noise under (seed, chains[c]) (device, n_chains words),
// or (seed, chain) when chains is null (one chain). taps, coef (kernel 2's
// 10 floats), fgp_coef (max(niter_tv, niter_inner) floats), qcoef: host,
// as for lmc_myula_block. The halo is the least exact one, h = max(niter_tv
// + 1, the taps' reach, 2 for mctv, niter_inner + 1 for metv); the interior
// and the CTA size (512 or 1024 threads) are the caller's
// (kernels/myula_tiled.py::tiled_plan). Returns the cudaError_t of the
// launches (0 on success), or -1 on arguments outside the supported range or
// when the tile does not fit the card's shared memory.
extern "C" int lmc_myula_tiled(
    float* x, float* parity, const float* atbs, float* mean, float* m2,
    float* qh, float* qn, int ny, int nx, int n_chains,
    const unsigned int* chains, const float* taps, int rank, int ky,
    int kx, int oy, int ox, int n_steps, int niter_tv, float tv_step, int fgp,
    const float* fgp_coef, int mode, int niter_inner, int with_noise,
    const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, int ty, int tx, int threads, void* stream) {
  MyulaTile p;
  if (!lmc_taps(&p.taps, taps, rank, ky, kx, oy, ox) || n_q < 0 ||
      n_q > LMC_MAXQ || thin < 1 || ny < 2 || nx < 2 || n_steps % 2 ||
      mode < MODE_TV || mode > MODE_METV || niter_tv < 0 ||
      niter_tv > LMC_MAXTRIP || niter_inner < 0 || niter_inner > LMC_MAXTRIP ||
      ty < 1 || tx < 1 || (threads != 512 && threads != 1024) || n_chains < 1 ||
      n_chains > 65535 || (n_chains > 1 && chains == nullptr))
    return -1;
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
  // x / gamma as x * (1 / gamma), the reciprocal of the float gamma, as torch
  // divides a CUDA tensor by a Python scalar
  p.inv_tv_gamma = 1.0f / coef[5];
  p.inv_gamma_mc = 1.0f / coef[7];
  p.tv_step = tv_step;
  p.niter_tv = niter_tv;
  p.niter_inner = niter_inner;
  p.fgp = fgp;
  p.mode = mode;
  const int n_coef = tl_max(niter_tv, mode == MODE_METV ? niter_inner : 0);
  for (int i = 0; i < LMC_MAXTRIP; ++i) p.fgp_coef[i] = i < n_coef ? fgp_coef[i] : 0.0f;
  int h = tl_max(niter_tv + 1, tl_max(lmc_taps_reach_y(p.taps), lmc_taps_reach_x(p.taps)));
  if (mode == MODE_MCTV) h = tl_max(h, 2);
  if (mode == MODE_METV) h = tl_max(h, niter_inner + 1);
  p.h = h;
  p.ry = lmc_taps_reach_y(p.taps);

  p.ty = ty;
  p.tx = tx;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tl_smem_bytes(ty, tx, h, fgp);
  if (smem + sizeof(float) * LMC_MAXTRIP > (size_t)optin) return -1;  // + static
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, n_chains);
  auto step = threads == 512 ? tl_myula_step<512> : tl_myula_step<1024>;
  e = (cudaError_t)tl_smem(step, smem);
  if (e != cudaSuccess) return (int)e;
  const Sched sc =
      tl_sched(n_q, thin, with_noise, qcoef, seed, chain, chains, step0, burn, cnt0);
  cudaStream_t s = (cudaStream_t)stream;
  for (int it = 0; it < n_steps; ++it) {
    const float* src = it % 2 ? parity : x;
    float* dst = it % 2 ? x : parity;
    step<<<grid, threads, smem, s>>>(src, dst, atbs, mean, m2, qh, qn, ny, nx,
                                     p, sc, step0 + it);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The current device's SM count and opt-in shared memory a CTA, into out[0]
// and out[1], for the host planners of kernels 3, 6 and 7. Returns the
// cudaError_t.
extern "C" int lmc_card_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// Kernel 7: n_steps (even) ULPDA steps of n_chains chains of one posterior
// on x (xp the previous sample, the parity partner), the Gradient2D dual
// (py, px) (dual 0 l1, 1 l21), Welford on mean/m2 and P^2 on qh/qn, all in
// place (float32, row-major, contiguous, on the current device); x, xp, py,
// px, mean, m2 (n_chains, ny, nx), the markers as kernel 6's. Each launch
// carries every chain, grid layer z chain z; the chains share atb, and chain
// c draws its noise under (seed, chains[c]), or (seed, chain) when chains is
// null (one chain). atb: A^T b (unscaled). cheb: host, 2 * niter_solve
// floats (c_d, c_r) per sweep; coef: host, kernel 3's 10 floats [tau, mu,
// theta, noise_amp, tau sigma, g_sigma, tau lamda, gamma_mc, 1 / gamma_mc,
// tau lamda / gamma_mc]; the ME-TV envelope is niter_inner cold Chambolle
// trips at step 0.25. Each step is the dual pass before (gfirst) or after the
// primal pass. The halo is the cone's (ul_halo); the interior and the CTA
// size (512 or 1024 threads) are the caller's
// (kernels/ulpda_tiled.py::ulpda_tiled_plan). Returns the cudaError_t of the
// launches, or -1 on arguments outside the supported range or when the tile
// does not fit the card's shared memory.
extern "C" int lmc_ulpda_tiled(
    float* x, float* xp, float* py, float* px, const float* atb, float* mean,
    float* m2, float* qh, float* qn, int ny, int nx, int n_chains,
    const unsigned int* chains, const float* taps,
    int rank, int ky, int kx, int oy, int ox, int n_steps, int niter_solve,
    const float* cheb, int gfirst, int dual, int mode, int niter_inner,
    int with_noise, const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, int ty, int tx, int threads, void* stream) {
  UlpdaTile p;
  Taps tp;
  if (!lmc_taps(&tp, taps, rank, ky, kx, oy, ox) || n_q < 0 ||
      n_q > LMC_MAXQ || thin < 1 || ny < 2 || nx < 2 || n_steps % 2 ||
      mode < MODE_TV || mode > MODE_METV || dual < 0 || dual > 1 ||
      niter_solve < 0 || niter_solve > LMC_MAXTRIP || niter_inner < 0 ||
      niter_inner > LMC_MAXTRIP || ty < 1 || tx < 1 ||
      (threads != 512 && threads != 1024) || n_chains < 1 || n_chains > 65535 ||
      (n_chains > 1 && chains == nullptr))
    return -1;
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
  p.inv_gamma_mc = 1.0f / coef[7];
  p.tv_step = 0.25f;
  p.niter_solve = niter_solve;
  p.mode = mode;
  p.niter_inner = niter_inner;
  p.fgp = 0;
  p.l21 = dual == 1;
  for (int sw = 0; sw < LMC_MAXTRIP; ++sw) {
    p.cheb[sw][0] = sw < niter_solve ? cheb[2 * sw] : 0.0f;
    p.cheb[sw][1] = sw < niter_solve ? cheb[2 * sw + 1] : 0.0f;
    p.fgp_coef[sw] = 0.0f;
  }
  p.ry = lmc_taps_reach_y(tp);
  p.reach = tl_max(p.ry, lmc_taps_reach_x(tp));
  p.grow = p.reach;
  p.h = ul_halo(p.reach, p.grow, niter_solve, mode, niter_inner);
  p.ty = ty;
  p.tx = tx;
  ul_tap_lists(&p, tp, tx + 2 * p.h);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t sy = ty + 2 * p.h, sx = tx + 2 * p.h;
  const size_t smem = sizeof(float) * 5 * sy * sx + sizeof(int) * (sy + sx);
  if (smem + sizeof(float) * 2 * LMC_MAXTRIP > (size_t)optin) return -1;  // + static
  auto primal = threads == 512 ? tl_ulpda_primal<512> : tl_ulpda_primal<1024>;
  e = (cudaError_t)tl_smem(primal, smem);
  if (e != cudaSuccess) return (int)e;
  const Sched sc =
      tl_sched(n_q, thin, with_noise, qcoef, seed, chain, chains, step0, burn, cnt0);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, n_chains);
  const dim3 dgrid = lmc_grid(ny, nx, n_chains), dblock = lmc_block();
  for (int it = 0; it < n_steps; ++it) {
    float* src = it % 2 ? xp : x;
    float* dst = it % 2 ? x : xp;
    if (gfirst)  // xbar of the previous step: (current, the stale partner)
      tl_ulpda_dual<<<dgrid, dblock, 0, s>>>(src, dst, py, px, ny, nx, p.mu,
                                             p.theta, p.g_sigma, p.l21);
    primal<<<grid, threads, smem, s>>>(src, dst, py, px, atb, mean, m2, qh, qn,
                                       ny, nx, p, sc, step0 + it);
    if (!gfirst)
      tl_ulpda_dual<<<dgrid, dblock, 0, s>>>(dst, src, py, px, ny, nx, p.mu,
                                             p.theta, p.g_sigma, p.l21);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
