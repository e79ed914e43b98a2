// Kernel 2: n_steps fused MYULA steps on the TV-deblurring posterior, with
// streaming Welford moments and P^2 quantile markers, for the plain L2 data
// term (mode tv) and the nonconvex MC-TV and ME-TV data terms.
//
// Replaces lmc_atomi_tpu/kernels/myula_fused.py::myula_tv_block_update
// (_block_kernel), which runs a whole block of steps inside one TPU core with
// every field resident in VMEM. Hopper has no 128 MiB scratch, so the fields
// stay in global memory (at 512^2 the ~20 MiB of a 95%-CI run fits the 50 MB
// L2) and one host call issues, for each step g = step0 + i:
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
// Each launch is bound by device-memory bytes and, at 512^2, by launch
// latency: a cold-10 step is 13 launches of a few us. Persistent launches,
// shared-memory row bands and CUDA graphs are later work.
#include "block_common.cuh"

namespace {

// Data-term modes of the block (myula_fused.py::_fused_mode).
enum { MODE_TV = 0, MODE_MCTV = 1, MODE_METV = 2 };

struct UpdateParams {
  float c_keep, c_grad, c_prox, noise_amp, tv_gamma;
  float lamda, gamma_mc, c_env;  // nonconvex modes: lamda, gamma, lamda/gamma
  float w, inv_denom;
  int mode, with_noise, with_stats, n_q, c_prev;
  uint32_t seed, chain, step;
  float qcoef[LMC_MAXQ][3];
};

// (c): the nonconvex correction of the data gradient, prox, MYULA update,
// noise, Welford and P^2, in place on x/mean/m2/qh/qn. (ay, ax) is the MC-TV
// clamped gradient of x (mode mctv) or the ME-TV envelope dual (mode metv).
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
//   grad: (ny, nx) scratch; tmp: (rank, ny, nx) scratch; duals: (8, ny, nx)
//   for the TV prox; aux: (8, ny, nx) for the ME-TV envelope prox, or
//   (2, ny, nx) for the MC-TV clamped gradient (null in mode tv).
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
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the supported range.
extern "C" int lmc_myula_block(
    float* x, const float* atbs, float* mean, float* m2, float* qh, float* qn,
    float* grad, float* tmp, float* duals, float* aux, int ny, int nx,
    const float* taps, int rank, int ky, int kx, int oy, int ox, int n_steps,
    int niter_tv, float tv_step, int fgp, const float* fgp_coef, int tv_warm,
    int mode, int niter_inner, int with_noise, int with_stats,
    const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, void* stream) {
  Taps t;
  if (!lmc_taps(&t, taps, rank, ky, kx, oy, ox) || n_q < 0 || n_q > LMC_MAXQ ||
      thin < 1 || ny < 2 || nx < 2 || mode < MODE_TV || mode > MODE_METV ||
      (mode != MODE_TV && aux == nullptr))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  const size_t npix = (size_t)ny * nx;

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
  for (int jq = 0; jq < n_q; ++jq)
    for (int m = 0; m < 3; ++m) u.qcoef[jq][m] = qcoef[3 * jq + m];
  const float sigma = coef[4];
  // x / gamma as x * (1 / gamma), the reciprocal of the float gamma, as torch
  // divides a CUDA tensor by a Python scalar
  const float inv_tv_gamma = 1.0f / coef[5];
  const float inv_gamma_mc = 1.0f / coef[7];
  const float clamp_mc = coef[8];

  const DualBufs tvb = lmc_dual_bufs(duals, npix);
  const DualBufs envb = lmc_dual_bufs(aux, npix);
  int cur = -1;      // index into tvb.P of the carried TV dual; -1 is zero
  int cur_env = -1;  // the same for the envelope dual

  for (int it = 0; it < n_steps; ++it) {
    const long long g = step0 + it;
    blk_rowconv<<<grid, block, 0, s>>>(x, tmp, ny, nx, t);
    blk_colconv<<<grid, block, 0, s>>>(tmp, atbs, grad, ny, nx, t, sigma);

    const float* ay = nullptr;
    const float* ax = nullptr;
    if (mode == MODE_MCTV) {
      blk_mctv_clamp<<<grid, block, 0, s>>>(x, aux, aux + npix, ny, nx,
                                            clamp_mc);
      ay = aux;
      ax = aux + npix;
    } else if (mode == MODE_METV) {
      cur_env = lmc_tv_trips(x, envb, tv_warm ? cur_env : -1, niter_inner,
                             fgp, tv_step, fgp_coef, inv_gamma_mc, ny, nx, s);
      ay = lmc_dual_y(envb, cur_env);
      ax = lmc_dual_x(envb, cur_env);
    }
    cur = lmc_tv_trips(x, tvb, tv_warm ? cur : -1, niter_tv, fgp, tv_step,
                       fgp_coef, inv_tv_gamma, ny, nx, s);

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
