// Kernels 4 and 5: n_steps fused wavelet-l1 MYULA steps (lmc_wavelet_block)
// and n_steps fused wavelet-dual ULPDA steps (lmc_ulpda_wavelet_block) on the
// inpainting posterior L2Data(Mask), with streaming Welford moments and P^2
// quantile markers.
//
// Replace lmc_atomi_tpu/kernels/wavelet_fused.py::wavelet_block_update
// (_wavelet_kernel) and ::ulpda_wavelet_block_update (_ulpda_wavelet_kernel),
// which keep the whole image in one TPU core's VMEM for a block of steps.
// Hopper cannot hold a 512^2 image in one SM, but it does not need to:
//
// Haar (taps 2). The interleaved Haar transform of `levels` levels pairs
// slots only inside aligned 2^levels squares, and every other term of a step
// (masked gradient, soft threshold or l-inf clip, mask prox, update, noise,
// Welford, P^2) is per pixel. So one launch runs the whole block of steps:
// each CTA owns a region of whole tiles (at most 32 x 32 pixels, 4 per
// thread), keeps its pixels' state (x, the ULPDA dual c and xbar, y, the
// mask, the moments and the P^2 markers) in registers across all n_steps, and
// runs each transform in shared memory with a barrier between butterfly
// passes. Device memory is read once at the start and written once at the
// end. The bound is the Philox noise (~100 integer operations per pixel and
// step) and the barriers of the butterfly passes (4 levels x 2 a transform).
//
// Daubechies D4/D8 (taps 4, 8). The periodic filter banks wrap around the
// whole image at every level, so they are not tile-local: one host call
// makes, per step, one launch per (level, axis) pass with ping-pong buffers
// in global memory (the soft threshold, or the dual's clip, fused into the
// last forward pass), and one per-pixel launch for the update, noise, Welford
// and P^2. Bound by launch latency at 512^2 (13 launches a MYULA step at 3
// levels). A faster D4/D8 (a cluster of CTAs sharing the image through
// distributed shared memory) is later work. A Haar transform of more levels
// than a CTA's region holds (2^levels > LMC_TILE_SIDE; the host passes
// rh = rw = 0) takes the same per-level launches, each pass the Haar
// butterfly (a + b) * (1/sqrt2), (a - b) * (1/sqrt2) of _haar_pass
// (block_common.cuh: lmc_haar_point, shared with kernel 3's wl1 dual), not
// the 2-tap filter bank, whose sum of products rounds otherwise.
//
// Every operation rounds as in the plain torch versions
// (wavelet_fused.py::*_ref), with --fmad=false: the Haar butterflies multiply
// by the float 1/sqrt2, the filter banks sum in Python's sum() order,
// 1 / (1 + ts m) is a division, and a division by a host scalar is a multiply
// by its float reciprocal. The noise is lmc_normal at (seed, chain, pixel, g),
// the function of core/random.py::normal_field.
#include "block_common.cuh"

namespace {

// Coefficients as the host packs them (wavelet_fused.py::_myula_coefs,
// _ulpda_coefs):
//   MYULA: 1 - tau/gamma, tau, tau/gamma, noise_scale sqrt(2 tau), sig, thr
//   ULPDA: tau, mu, theta, noise_scale sqrt(2 tau), tau sig, g_sigma
struct Coef {
  float c[6];
};

// Daubechies analysis filter h and its mirror g, taps <= 8.
struct Filt {
  int taps;
  float h[8];
  float g[8];
};

__device__ __forceinline__ float soft(float c, float thr) {
  const float sg = c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f);
  return sg * fmaxf(fabsf(c) - thr, 0.0f);
}

__device__ __forceinline__ float clip(float v, float r) {
  return fminf(fmaxf(v, -r), r);
}

// --- Haar: the whole block of steps in one launch ---------------------------

// The per-pixel state one thread keeps in registers across the block.
template <int NQ>
struct PixelStats {
  float mu[LMC_TILE_PPT], m2[LMC_TILE_PPT];
  float q[LMC_TILE_PPT][NQ > 0 ? NQ : 1][5];
  float n3[LMC_TILE_PPT][NQ > 0 ? NQ : 1][3];
};

template <int NQ>
__device__ __forceinline__ void stats_load(PixelStats<NQ>& st, const int* kk,
                                           const float* mean, const float* m2,
                                           const float* qh, const float* qn,
                                           size_t npix, const Sched& sc) {
#pragma unroll
  for (int e = 0; e < LMC_TILE_PPT; ++e) {
    st.mu[e] = 0.0f;
    st.m2[e] = 0.0f;
    if (kk[e] < 0) continue;
    if (sc.with_stats) {
      st.mu[e] = mean[kk[e]];
      st.m2[e] = m2[kk[e]];
    }
#pragma unroll
    for (int jq = 0; jq < NQ; ++jq) {
#pragma unroll
      for (int m = 0; m < 5; ++m) st.q[e][jq][m] = qh[(5 * jq + m) * npix + kk[e]];
#pragma unroll
      for (int m = 0; m < 3; ++m) st.n3[e][jq][m] = qn[(3 * jq + m) * npix + kk[e]];
    }
  }
}

template <int NQ>
__device__ __forceinline__ void stats_store(const PixelStats<NQ>& st,
                                            const int* kk, float* mean,
                                            float* m2, float* qh, float* qn,
                                            size_t npix, const Sched& sc) {
#pragma unroll
  for (int e = 0; e < LMC_TILE_PPT; ++e) {
    if (kk[e] < 0) continue;
    if (sc.with_stats) {
      mean[kk[e]] = st.mu[e];
      m2[kk[e]] = st.m2[e];
    }
#pragma unroll
    for (int jq = 0; jq < NQ; ++jq) {
#pragma unroll
      for (int m = 0; m < 5; ++m) qh[(5 * jq + m) * npix + kk[e]] = st.q[e][jq][m];
#pragma unroll
      for (int m = 0; m < 3; ++m) qn[(3 * jq + m) * npix + kk[e]] = st.n3[e][jq][m];
    }
  }
}

// Welford and P^2 of the thread's pixel e.
template <int NQ>
__device__ __forceinline__ void stats_record(PixelStats<NQ>& st, int e,
                                             float xn, const Sched& sc,
                                             const StepW& sw) {
  if (sc.with_stats) lmc_welford(xn, &st.mu[e], &st.m2[e], sw);
  if (!sw.record) return;
#pragma unroll
  for (int jq = 0; jq < NQ; ++jq)
    p2_update(xn, st.q[e][jq], st.n3[e][jq], sw.c_prev, sc.qcoef[jq]);
}

// Kernel 4, Haar: x <- (1 - tau/gamma) x - tau (sig m)(m x - y)
//                     + (tau/gamma) W^T soft(W x, thr) + noise
template <int NQ>
__global__ void __launch_bounds__(LMC_TILE_THREADS)
wv_myula_haar(float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ msk, float* __restrict__ mean,
              float* __restrict__ m2, float* __restrict__ qh,
              float* __restrict__ qn, int nx, size_t npix, int rh, int rw,
              int levels, int n_steps, Coef cf, Sched sc) {
  __shared__ float buf[LMC_TILE_SIDE * LMC_TILE_SIDE];
  const float c_keep = cf.c[0], c_grad = cf.c[1], c_prox = cf.c[2];
  const float noise_amp = cf.c[3], sig = cf.c[4], thr = cf.c[5];
  int kk[LMC_TILE_PPT];
  float xv[LMC_TILE_PPT], yv[LMC_TILE_PPT], mv[LMC_TILE_PPT], sm[LMC_TILE_PPT];
  PixelStats<NQ> st;
#pragma unroll
  for (int e = 0; e < LMC_TILE_PPT; ++e) {
    kk[e] = lmc_region_pixel(e * LMC_TILE_THREADS + threadIdx.x, rh, rw, nx);
    xv[e] = yv[e] = mv[e] = sm[e] = 0.0f;
    if (kk[e] < 0) continue;
    xv[e] = x[kk[e]];
    yv[e] = y[kk[e]];
    mv[e] = msk[kk[e]];
    sm[e] = sig * mv[e];
  }
  stats_load(st, kk, mean, m2, qh, qn, npix, sc);

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
#pragma unroll
    for (int e = 0; e < LMC_TILE_PPT; ++e)
      if (kk[e] >= 0) buf[e * LMC_TILE_THREADS + threadIdx.x] = xv[e];
    __syncthreads();
    lmc_haar_fwd(buf, rh, rw, levels);
#pragma unroll
    for (int e = 0; e < LMC_TILE_PPT; ++e) {
      const int li = e * LMC_TILE_THREADS + threadIdx.x;
      if (kk[e] >= 0) buf[li] = soft(buf[li], thr);
    }
    __syncthreads();
    lmc_haar_inv(buf, rh, rw, levels);
    const StepW sw = lmc_step_w(sc, g);
#pragma unroll
    for (int e = 0; e < LMC_TILE_PPT; ++e) {
      if (kk[e] < 0) continue;
      const float p = buf[e * LMC_TILE_THREADS + threadIdx.x];
      const float grad = sm[e] * (mv[e] * xv[e] - yv[e]);
      float xn = c_keep * xv[e] - c_grad * grad + c_prox * p;
      if (sc.with_noise)
        xn = xn + noise_amp * lmc_normal(sc.seed, sc.chain, (uint32_t)kk[e],
                                         (uint32_t)g);
      xv[e] = xn;
      stats_record(st, e, xn, sc, sw);
    }
    __syncthreads();  // buf is rewritten by the next step
  }
#pragma unroll
  for (int e = 0; e < LMC_TILE_PPT; ++e)
    if (kk[e] >= 0) x[kk[e]] = xv[e];
  stats_store(st, kk, mean, m2, qh, qn, npix, sc);
}

// Kernel 5, Haar: the dual update c <- clip(c + mu W xbar) and the primal
// update x' = (x - tau W^T c + ts m y) / (1 + ts m) + noise,
// xbar = x' + theta (x' - x), dual first with gfirst.
template <int NQ>
__global__ void __launch_bounds__(LMC_TILE_THREADS)
wv_ulpda_haar(float* __restrict__ x, float* __restrict__ c,
              float* __restrict__ xbar, const float* __restrict__ y,
              const float* __restrict__ msk, float* __restrict__ mean,
              float* __restrict__ m2, float* __restrict__ qh,
              float* __restrict__ qn, int nx, size_t npix, int rh, int rw,
              int levels, int n_steps, int gfirst, Coef cf, Sched sc) {
  __shared__ float buf[LMC_TILE_SIDE * LMC_TILE_SIDE];
  const float tau = cf.c[0], mu = cf.c[1], theta = cf.c[2];
  const float noise_amp = cf.c[3], ts = cf.c[4], g_sigma = cf.c[5];
  int kk[LMC_TILE_PPT];
  float xv[LMC_TILE_PPT], cv[LMC_TILE_PPT], xb[LMC_TILE_PPT];
  float atb[LMC_TILE_PPT], den[LMC_TILE_PPT];
  PixelStats<NQ> st;
#pragma unroll
  for (int e = 0; e < LMC_TILE_PPT; ++e) {
    kk[e] = lmc_region_pixel(e * LMC_TILE_THREADS + threadIdx.x, rh, rw, nx);
    xv[e] = cv[e] = xb[e] = atb[e] = den[e] = 0.0f;
    if (kk[e] < 0) continue;
    xv[e] = x[kk[e]];
    cv[e] = c[kk[e]];
    // gfirst = 0 never reads the incoming xbar
    xb[e] = gfirst ? xbar[kk[e]] : xv[e];
    const float m = msk[kk[e]];
    // L2Data(Mask).prox in closed form: (v + ts m y) / (1 + ts m)
    atb[e] = ts * m * y[kk[e]];
    den[e] = 1.0f / (1.0f + ts * m);
  }
  stats_load(st, kk, mean, m2, qh, qn, npix, sc);

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == (gfirst != 0)) {
        // dual: c <- clip(c + mu W xbar, -g_sigma, g_sigma)
#pragma unroll
        for (int e = 0; e < LMC_TILE_PPT; ++e)
          if (kk[e] >= 0) buf[e * LMC_TILE_THREADS + threadIdx.x] = xb[e];
        __syncthreads();
        lmc_haar_fwd(buf, rh, rw, levels);
#pragma unroll
        for (int e = 0; e < LMC_TILE_PPT; ++e)
          if (kk[e] >= 0)
            cv[e] = clip(cv[e] + mu * buf[e * LMC_TILE_THREADS + threadIdx.x],
                         g_sigma);
      } else {
        // primal: W^T c, the mask prox, noise, xbar, statistics
#pragma unroll
        for (int e = 0; e < LMC_TILE_PPT; ++e)
          if (kk[e] >= 0) buf[e * LMC_TILE_THREADS + threadIdx.x] = cv[e];
        __syncthreads();
        lmc_haar_inv(buf, rh, rw, levels);
        const StepW sw = lmc_step_w(sc, g);
#pragma unroll
        for (int e = 0; e < LMC_TILE_PPT; ++e) {
          if (kk[e] < 0) continue;
          const float p = buf[e * LMC_TILE_THREADS + threadIdx.x];
          float xn = (xv[e] - tau * p + atb[e]) * den[e];
          if (sc.with_noise)
            xn = xn + noise_amp * lmc_normal(sc.seed, sc.chain,
                                             (uint32_t)kk[e], (uint32_t)g);
          xb[e] = xn + theta * (xn - xv[e]);
          xv[e] = xn;
          stats_record(st, e, xn, sc, sw);
        }
      }
      __syncthreads();  // buf is rewritten by the next transform
    }
  }
#pragma unroll
  for (int e = 0; e < LMC_TILE_PPT; ++e) {
    if (kk[e] < 0) continue;
    x[kk[e]] = xv[e];
    c[kk[e]] = cv[e];
    xbar[kk[e]] = xb[e];
  }
  stats_store(st, kk, mean, m2, qh, qn, npix, sc);
}

// --- Daubechies: one launch per (level, axis) pass --------------------------

enum { EPI_NONE = 0, EPI_SOFT = 1, EPI_CLIP = 2 };

// One periodic filter-bank pass at stride s along axis on the lattice where
// the other index % s == 0 (wavelet_fused.py::_db_pass); with rd(k) the
// value k s further along the axis, wrapped around the whole image:
//   analysis:  slot % 2s == 0: sum_i h[i] rd(i); == s: sum_i g[i] rd(i - 1)
//   synthesis: == 0: sum_i h[2i] rd(-2i) + g[2i] rd(1 - 2i)
//              == s: sum_i h[2i+1] rd(-2i - 1) + g[2i+1] rd(-2i)
// Other slots copy through; s = 0 copies every pixel (no level applies). The
// epilogue writes soft(v, a0) to out (EPI_SOFT), or updates the dual in place,
// c = clip(c + a0 v, a1), without writing out (EPI_CLIP).
__global__ void wv_db_pass(const float* __restrict__ in, float* __restrict__ out,
                           float* __restrict__ c, int ny, int nx, int s,
                           int axis, int inverse, Filt f, int epi, float a0,
                           float a1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  float v = in[k];
  if (s > 0 && f.taps == 2) {
    v = lmc_haar_point(in, ny, nx, i, j, s, axis);
  } else if (s > 0) {
    const int idx = axis == 0 ? i : j;
    const int other = axis == 0 ? j : i;
    const int n = axis == 0 ? ny : nx;
    const int r = idx & (2 * s - 1);
    if ((other & (s - 1)) == 0 && (r == 0 || r == s)) {
      auto rd = [&](int kk) {
        const int t = wrap(idx + kk * s, n);
        return axis == 0 ? in[t * nx + j] : in[i * nx + t];
      };
      float acc = 0.0f;
      if (!inverse) {
        for (int m = 0; m < f.taps; ++m)
          acc = acc + (r == 0 ? f.h[m] * rd(m) : f.g[m] * rd(m - 1));
      } else {
        for (int m = 0; m < f.taps / 2; ++m) {
          const float term =
              r == 0 ? f.h[2 * m] * rd(-2 * m) + f.g[2 * m] * rd(1 - 2 * m)
                     : f.h[2 * m + 1] * rd(-2 * m - 1) + f.g[2 * m + 1] * rd(-2 * m);
          acc = acc + term;
        }
      }
      v = acc;
    }
  }
  if (epi == EPI_CLIP) {
    c[k] = clip(c[k] + a0 * v, a1);
  } else {
    out[k] = epi == EPI_SOFT ? soft(v, a0) : v;
  }
}

// Kernel 4's per-step update given p = W^T soft(W x): in place on x and the
// statistics.
__global__ void wv_myula_update(float* __restrict__ x, const float* __restrict__ p,
                                const float* __restrict__ y,
                                const float* __restrict__ msk,
                                float* __restrict__ mean, float* __restrict__ m2,
                                float* __restrict__ qh, float* __restrict__ qn,
                                int ny, int nx, Coef cf, Sched sc, long long g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float xv = x[k], m = msk[k];
  const float grad = cf.c[4] * m * (m * xv - y[k]);
  float xn = cf.c[0] * xv - cf.c[1] * grad + cf.c[2] * p[k];
  if (sc.with_noise)
    xn = xn + cf.c[3] * lmc_normal(sc.seed, sc.chain, (uint32_t)k, (uint32_t)g);
  x[k] = xn;
  lmc_record_global(xn, k, (size_t)ny * nx, mean, m2, qh, qn, sc,
                    lmc_step_w(sc, g));
}

// Kernel 5's per-step primal update given p = W^T c: in place on x, xbar
// and the statistics.
__global__ void wv_ulpda_update(float* __restrict__ x, const float* __restrict__ p,
                                float* __restrict__ xbar,
                                const float* __restrict__ y,
                                const float* __restrict__ msk,
                                float* __restrict__ mean, float* __restrict__ m2,
                                float* __restrict__ qh, float* __restrict__ qn,
                                int ny, int nx, Coef cf, Sched sc, long long g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  const float tau = cf.c[0], theta = cf.c[2], ts = cf.c[4];
  const float xv = x[k], m = msk[k];
  const float atb = ts * m * y[k];
  const float den = 1.0f / (1.0f + ts * m);
  float xn = (xv - tau * p[k] + atb) * den;
  if (sc.with_noise)
    xn = xn + cf.c[3] * lmc_normal(sc.seed, sc.chain, (uint32_t)k, (uint32_t)g);
  x[k] = xn;
  xbar[k] = xn + theta * (xn - xv);
  lmc_record_global(xn, k, (size_t)ny * nx, mean, m2, qh, qn, sc,
                    lmc_step_w(sc, g));
}

// The forward (inverse = 0) or inverse transform of src through the ping-pong
// buffers, epilogue epi on the last pass (a copy pass with s = 0 when no level
// applies and an epilogue is asked for). Returns the buffer holding the
// result (src itself when nothing was launched).
const float* db_transform(const float* src, float* const bufs[2], float* c,
                          int ny, int nx, int levels, int inverse,
                          const Filt& f, int epi, float a0, float a1,
                          cudaStream_t s) {
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  int out = 0;
  if (levels == 0) {
    if (epi == EPI_NONE) return src;
    wv_db_pass<<<grid, block, 0, s>>>(src, bufs[0], c, ny, nx, 0, 0, inverse,
                                      f, epi, a0, a1);
    return bufs[0];
  }
  for (int n = 0; n < levels; ++n) {
    const int lv = inverse ? levels - 1 - n : n;
    for (int a = 0; a < 2; ++a) {
      const int axis = inverse ? 1 - a : a;
      const bool last = n == levels - 1 && a == 1;
      wv_db_pass<<<grid, block, 0, s>>>(src, bufs[out], c, ny, nx, 1 << lv,
                                        axis, inverse, f,
                                        last ? epi : EPI_NONE, a0, a1);
      src = bufs[out];
      out ^= 1;
    }
  }
  return src;
}

bool load_common(Sched* sc, Filt* f, int ny, int nx, int taps,
                 const float* filt, int levels, int rh, int rw, int with_noise,
                 int with_stats, const float* qcoef, int n_q, int thin,
                 unsigned int seed, unsigned int chain, long long step0,
                 long long burn, long long cnt0, const float* mean,
                 const float* qh, const float* qn, float* const bufs[2]) {
  if (ny < 2 || nx < 2 || n_q < 0 || n_q > LMC_MAXQ || thin < 1 || levels < 0)
    return false;
  if (taps == 2 && rh > 0) {
    if (!lmc_region_ok(ny, nx, rh, rw, levels)) return false;
  } else if (taps == 2 || taps == 4 || taps == 8) {
    if (bufs[0] == nullptr || bufs[1] == nullptr) return false;
  } else {
    return false;
  }
  if ((with_stats && mean == nullptr) || (n_q > 0 && (qh == nullptr || qn == nullptr)))
    return false;
  f->taps = taps;
  for (int m = 0; m < 8; ++m) {
    f->h[m] = filt[m];
    f->g[m] = filt[8 + m];
  }
  sc->step0 = step0;
  sc->burn = burn;
  sc->cnt0 = cnt0;
  sc->thin = thin;
  sc->n_q = n_q;
  sc->with_noise = with_noise;
  sc->with_stats = with_stats;
  sc->seed = seed;
  sc->chain = chain;
  for (int jq = 0; jq < LMC_MAXQ; ++jq)
    for (int m = 0; m < 3; ++m) sc->qcoef[jq][m] = jq < n_q ? qcoef[3 * jq + m] : 0.0f;
  return true;
}

}  // namespace

// Kernel 4: n_steps MYULA steps in place on x, mean, m2, qh, qn (float32,
// row-major, contiguous, on the current device).
//   y, m: the observation and the 0/1 mask; bufs: (2, ny, nx) scratch for
//   the per-level launches (null for the Haar tiles); taps 2, 4 or 8 with
//   filt, host, 16 floats: h, then g, each zero padded to 8; levels: the
//   levels the transform applies (wavelet_fused.py::dwt_levels); rh x rw: the
//   region of one CTA for Haar in tiles, 0 x 0 for Haar in per-level launches.
//   coef: host, 6 floats [1 - tau/gamma, tau, tau/gamma,
//         noise_scale sqrt(2 tau), sig, thr].
//   qcoef: host, n_q * 3 floats (dn - 1) / 4 for the interior markers.
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the supported range.
extern "C" int lmc_wavelet_block(
    float* x, const float* y, const float* m, float* mean, float* m2,
    float* qh, float* qn, float* bufs, int ny, int nx, int taps,
    const float* filt, int levels, int rh, int rw, int n_steps, int with_noise,
    int with_stats, const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, void* stream) {
  const size_t npix = (size_t)ny * nx;
  float* const pp[2] = {bufs, bufs ? bufs + npix : nullptr};
  Sched sc;
  Filt f;
  if (!load_common(&sc, &f, ny, nx, taps, filt, levels, rh, rw, with_noise,
                   with_stats, qcoef, n_q, thin, seed, chain, step0, burn,
                   cnt0, mean, qh, qn, pp))
    return -1;
  Coef cf;
  for (int i = 0; i < 6; ++i) cf.c[i] = coef[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (taps == 2 && rh > 0) {
    const dim3 grid(nx / rw, ny / rh);
#define LMC_WV_MYULA(NQ)                                                     \
  wv_myula_haar<NQ><<<grid, LMC_TILE_THREADS, 0, s>>>(                       \
      x, y, m, mean, m2, qh, qn, nx, npix, rh, rw, levels, n_steps, cf, sc)
    switch (n_q) {
      case 0: LMC_WV_MYULA(0); break;
      case 1: LMC_WV_MYULA(1); break;
      case 2: LMC_WV_MYULA(2); break;
      case 3: LMC_WV_MYULA(3); break;
      default: LMC_WV_MYULA(4); break;
    }
#undef LMC_WV_MYULA
    return (int)cudaGetLastError();
  }
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  for (int it = 0; it < n_steps; ++it) {
    const float* c = db_transform(x, pp, nullptr, ny, nx, levels, 0, f,
                                  EPI_SOFT, cf.c[5], 0.0f, s);
    // continue in the buffer the forward transform did not end in
    float* const inv_bufs[2] = {c == pp[0] ? pp[1] : pp[0], (float*)c};
    const float* p = db_transform(c, inv_bufs, nullptr, ny, nx, levels, 1, f,
                                  EPI_NONE, 0.0f, 0.0f, s);
    wv_myula_update<<<grid, block, 0, s>>>(x, p, y, m, mean, m2, qh, qn, ny,
                                           nx, cf, sc, step0 + it);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Kernel 5: n_steps wavelet-dual ULPDA steps in place on x, c, xbar, mean,
// m2, qh, qn (float32, row-major, contiguous, on the current device); the
// dual c is in the interleaved layout. With gfirst = 0 the incoming xbar is
// never read; the outgoing one is the genuine x' + theta (x' - x).
//   coef: host, 6 floats [tau, mu, theta, noise_scale sqrt(2 tau), tau sig,
//         g_sigma]; the rest as lmc_wavelet_block.
extern "C" int lmc_ulpda_wavelet_block(
    float* x, float* c, float* xbar, const float* y, const float* m,
    float* mean, float* m2, float* qh, float* qn, float* bufs, int ny, int nx,
    int taps, const float* filt, int levels, int rh, int rw, int n_steps,
    int gfirst, int with_noise, int with_stats, const float* qcoef, int n_q,
    int thin, const float* coef, unsigned int seed, unsigned int chain,
    long long step0, long long burn, long long cnt0, void* stream) {
  const size_t npix = (size_t)ny * nx;
  float* const pp[2] = {bufs, bufs ? bufs + npix : nullptr};
  Sched sc;
  Filt f;
  if (!load_common(&sc, &f, ny, nx, taps, filt, levels, rh, rw, with_noise,
                   with_stats, qcoef, n_q, thin, seed, chain, step0, burn,
                   cnt0, mean, qh, qn, pp))
    return -1;
  Coef cf;
  for (int i = 0; i < 6; ++i) cf.c[i] = coef[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (taps == 2 && rh > 0) {
    const dim3 grid(nx / rw, ny / rh);
#define LMC_WV_ULPDA(NQ)                                                     \
  wv_ulpda_haar<NQ><<<grid, LMC_TILE_THREADS, 0, s>>>(                       \
      x, c, xbar, y, m, mean, m2, qh, qn, nx, npix, rh, rw, levels, n_steps, \
      gfirst, cf, sc)
    switch (n_q) {
      case 0: LMC_WV_ULPDA(0); break;
      case 1: LMC_WV_ULPDA(1); break;
      case 2: LMC_WV_ULPDA(2); break;
      case 3: LMC_WV_ULPDA(3); break;
      default: LMC_WV_ULPDA(4); break;
    }
#undef LMC_WV_ULPDA
    return (int)cudaGetLastError();
  }
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  const float mu = cf.c[1], g_sigma = cf.c[5];
  for (int it = 0; it < n_steps; ++it) {
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == (gfirst != 0)) {
        db_transform(xbar, pp, c, ny, nx, levels, 0, f, EPI_CLIP, mu, g_sigma, s);
      } else {
        const float* p = db_transform(c, pp, nullptr, ny, nx, levels, 1, f,
                                      EPI_NONE, 0.0f, 0.0f, s);
        wv_ulpda_update<<<grid, block, 0, s>>>(x, p, xbar, y, m, mean, m2, qh,
                                               qn, ny, nx, cf, sc, step0 + it);
      }
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
