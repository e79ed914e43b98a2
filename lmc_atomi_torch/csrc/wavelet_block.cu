// Kernels 4 and 5: n_steps fused wavelet-l1 MYULA steps (lmc_wavelet_block)
// and n_steps fused wavelet-dual ULPDA steps (lmc_ulpda_wavelet_block) on the
// inpainting posterior L2Data(Mask), with streaming Welford moments and P^2
// quantile markers.
//
// Replace lmc_atomi_tpu/kernels/wavelet_fused.py::wavelet_block_update
// (_wavelet_kernel) and ::ulpda_wavelet_block_update (_ulpda_wavelet_kernel),
// which keep the whole image in one TPU core's VMEM for a block of steps.
// Hopper cannot hold a 512^2 image in one SM. The host names one of four
// routes before any launch (wavelet_fused.py::wavelet_plan) and passes its
// geometry; each entry point checks the fit (and the resident route the
// occupancy) and returns -1 where it fails:
//
// Warp (Haar, at most 3 levels, sides multiples of 8). The interleaved Haar
// transform of L levels pairs slots only inside aligned 2^L squares, and
// every other term of a step (masked gradient, soft threshold or l-inf clip,
// mask prox, update, noise, Welford, P^2) is per pixel. So one launch runs
// the whole block of steps, one warp an aligned 8 x 8 square, 2 pixels a
// lane, its state (x, the ULPDA dual c and xbar, y, the mask, the moments and
// the P^2 markers) in registers across all n_steps. Every butterfly is within
// a lane or one __shfl_xor_sync a value: no shared memory and no barrier in
// the step. Device memory is read once at the start and written once at the
// end. At 512^2 that is 4096 warps, ~31 an SM; the bound is the Philox noise
// (~100 integer operations per pixel and step).
//
// Tile (Haar, 4-5 levels, or sides that are not multiples of 8). As the warp
// route, but each CTA owns a region of whole 2^L tiles (at most 32 x 32
// pixels, 4 a thread) and runs each transform in shared memory with a
// barrier between butterfly passes.
//
// Resident (D4/D8 where every tile of the image is resident at once, 512^2).
// The periodic filter banks wrap around the whole image at every level, so
// they are not tile-local. One cooperative launch runs the block, one CTA a
// 2-D tile (at most one an SM), the tile's per-pixel state in registers (the
// dual c in shared memory) for the whole block. Each level is a phase: the
// CTA runs the level's first pass on its tile's lattice points and the
// second pass's reach beyond them, reading the previous phase's field from
// device memory through L2 (__ldcg) after a grid barrier, keeps that in
// shared memory, runs the second pass from there and writes its points to
// one of two fields. The soft threshold (kernel 4) or the dual's clip
// (kernel 5) applies where a coefficient becomes final; the last inverse
// level, which only writes the CTA's own pixels, runs the update, the noise,
// Welford and P^2 (markers in device memory) without a barrier. That is 2L
// grid barriers a step in place of 4L + 1 launches; a grid barrier costs
// ~1.3 us on the H100, ~40% of a 20 us D4 step at 512^2 (chip_smoke.py
// --turns 4). One phase a pass (4L barriers) took 1.4x as long.
//
// Passes (D4/D8 whose tiles do not all fit, 2048^2; Haar past 5 levels): one
// host call makes, per step, one launch per (level, axis) pass with
// ping-pong buffers in global memory (the soft threshold, or the dual's clip,
// fused into the last forward pass), and one per-pixel launch for the update,
// noise, Welford and P^2. A Haar pass is the butterfly (a + b) * (1/sqrt2),
// (a - b) * (1/sqrt2) of _haar_pass (block_common.cuh: lmc_haar_point,
// shared with kernel 3's wl1 dual), not the 2-tap filter bank, whose sum of
// products rounds otherwise.
//
// Chains: a call runs n_chains chains of one posterior (the "wavelet" chain
// farm), each with its own x, moments, markers (kernel 5: dual and xbar) and
// Philox chain word, sharing y and the mask, as the TPU's jax.vmap of the
// pallas_call runs one kernel with a chain grid axis. The warp, tile and
// per-level launches take every chain as a grid layer (blockIdx.z: WV_LAYER,
// lmc_chain_at; the ping-pong buffers plane-major); the resident route runs
// them in groups of per chains (wavelet_fused.py::wavelet_plan, G of
// myula_fused.py::chains_per_launch), one cooperative launch a group, grid
// layer z of a launch a chain with its own B0/B1. A chain takes the same
// operations as the one-chain call, so it equals that call bit for bit.
//
// Every operation rounds as in the plain torch versions
// (wavelet_fused.py::*_ref), with --fmad=false: the Haar butterflies multiply
// by the float 1/sqrt2, the filter banks sum in Python's sum() order,
// 1 / (1 + ts m) is a division, and a division by a host scalar is a multiply
// by its float reciprocal. The noise is lmc_normal at (seed, chain, pixel, g),
// the function of core/random.py::normal_field. So every route equals the
// plain version bit for bit (chip_smoke.py checks it).
#include <cooperative_groups.h>

#include "block_common.cuh"

// Routes (wavelet_fused.py: ROUTES)
enum { RT_PASSES = 0, RT_TILE = 1, RT_WARP = 2, RT_RESIDENT = 3 };

// Warp route: the side of a warp's square, the most levels it holds, a CTA
#define WV_SQ 8
#define WV_WARP_LEVELS 3
#define WV_WARP_THREADS 256
// Resident route: a CTA's threads and the most pixels a thread keeps
// (wavelet_fused.py: _RS_MAX_PIXELS = their product)
#define WV_RS_THREADS 512
#define WV_RS_PPT 8

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

// Grid layer z runs chain z of the launch: x, the moments and the markers
// move to its copies, npix floats and (5 + 3) n_q planes a chain
// (chain-major); y and the mask are shared, and the chain's Philox word is
// lmc_sched_chain's. One layer is the one-chain launch.
#define WV_LAYER(npix, n_q)                        \
  x = lmc_layer(x, npix);                          \
  mean = lmc_layer(mean, npix);                    \
  m2 = lmc_layer(m2, npix);                        \
  qh = lmc_layer(qh, 5 * (size_t)(n_q) * (npix));  \
  qn = lmc_layer(qn, 3 * (size_t)(n_q) * (npix))

__device__ __forceinline__ float soft(float c, float thr) {
  const float sg = c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f);
  return sg * fmaxf(fabsf(c) - thr, 0.0f);
}

__device__ __forceinline__ float clip(float v, float r) {
  return fminf(fmaxf(v, -r), r);
}

// --- Haar: the whole block of steps in one launch ---------------------------

// The per-pixel state one thread keeps in registers across the block, PPT
// pixels a thread.
template <int NQ, int PPT>
struct PixelStats {
  float mu[PPT], m2[PPT];
  float q[PPT][NQ > 0 ? NQ : 1][5];
  float n3[PPT][NQ > 0 ? NQ : 1][3];
};

template <int NQ, int PPT>
__device__ __forceinline__ void stats_load(PixelStats<NQ, PPT>& st, const int* kk,
                                           const float* mean, const float* m2,
                                           const float* qh, const float* qn,
                                           size_t npix, const Sched& sc) {
#pragma unroll
  for (int e = 0; e < PPT; ++e) {
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

template <int NQ, int PPT>
__device__ __forceinline__ void stats_store(const PixelStats<NQ, PPT>& st,
                                            const int* kk, float* mean,
                                            float* m2, float* qh, float* qn,
                                            size_t npix, const Sched& sc) {
#pragma unroll
  for (int e = 0; e < PPT; ++e) {
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
template <int NQ, int PPT>
__device__ __forceinline__ void stats_record(PixelStats<NQ, PPT>& st, int e,
                                             float xn, const Sched& sc,
                                             const StepW& sw) {
  if (sc.with_stats) lmc_welford(xn, &st.mu[e], &st.m2[e], sw);
  if (!sw.record) return;
#pragma unroll
  for (int jq = 0; jq < NQ; ++jq)
    p2_update(xn, st.q[e][jq], st.n3[e][jq], sw.c_prev, sc.qcoef[jq]);
}

// --- Haar, tile route: a CTA a region of whole tiles, shared memory --------

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
  WV_LAYER(npix, NQ);
  const uint32_t chain = lmc_sched_chain(sc);
  const float c_keep = cf.c[0], c_grad = cf.c[1], c_prox = cf.c[2];
  const float noise_amp = cf.c[3], sig = cf.c[4], thr = cf.c[5];
  int kk[LMC_TILE_PPT];
  float xv[LMC_TILE_PPT], yv[LMC_TILE_PPT], mv[LMC_TILE_PPT], sm[LMC_TILE_PPT];
  PixelStats<NQ, LMC_TILE_PPT> st;
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
        xn = xn + noise_amp * lmc_normal(sc.seed, chain, (uint32_t)kk[e],
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
  WV_LAYER(npix, NQ);
  c = lmc_layer(c, npix);
  xbar = lmc_layer(xbar, npix);
  const uint32_t chain = lmc_sched_chain(sc);
  const float tau = cf.c[0], mu = cf.c[1], theta = cf.c[2];
  const float noise_amp = cf.c[3], ts = cf.c[4], g_sigma = cf.c[5];
  int kk[LMC_TILE_PPT];
  float xv[LMC_TILE_PPT], cv[LMC_TILE_PPT], xb[LMC_TILE_PPT];
  float atb[LMC_TILE_PPT], den[LMC_TILE_PPT];
  PixelStats<NQ, LMC_TILE_PPT> st;
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
            xn = xn + noise_amp * lmc_normal(sc.seed, chain,
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

// --- Haar, warp route: one warp an aligned 8 x 8 square, no barrier --------
// Lane l holds the square's pixels (r, c) = (2 (l >> 3) + e, l & 7), e = 0, 1.
// At level lv (stride s = 2^lv) the butterflies pair rows r, r + s (axis 0)
// and columns c, c + s (axis 1) on the lattice r % s == 0, c % s == 0: rows
// 2k and 2k + 1 lie in one lane; past level 0 only e = 0 is on the lattice,
// and rows r, r ^ s lie in lanes l, l ^ (s << 2), columns c, c ^ s in lanes
// l, l ^ s. So each butterfly is in-lane or one __shfl_xor_sync a value.
// Slot p (index % 2s == 0) takes (a + b) * (1/sqrt2), slot q = p + s takes
// (a - b) * (1/sqrt2), a slot p's value and b slot q's (lmc_haar_pass).

// Image index of the lane's pixel e in square sq (row-major squares).
__device__ __forceinline__ int wp_pixel(int sq, int lane, int e, int nx) {
  const int per_row = nx / WV_SQ;
  const int r = (sq / per_row) * WV_SQ + 2 * (lane >> 3) + e;
  const int c = (sq % per_row) * WV_SQ + (lane & 7);
  return r * nx + c;
}

// One butterfly pass at stride s along axis on the warp's square; every lane
// of the warp takes part.
__device__ __forceinline__ void wp_haar_pass(float v[2], int lane, int s,
                                             int axis) {
  if (s == 1 && axis == 0) {
    const float a = v[0], b = v[1];
    v[0] = (a + b) * LMC_SQRT1_2;
    v[1] = (a - b) * LMC_SQRT1_2;
    return;
  }
  const int c = lane & 7;
  const int partner = axis == 0 ? s << 2 : s;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e == 1 && s > 1) break;  // odd rows are off the lattice past level 0
    const int r = 2 * (lane >> 3) + e;
    const float o = __shfl_xor_sync(0xffffffffu, v[e], partner);
    const int idx = axis == 0 ? r : c;
    if (((r | c) & (s - 1)) == 0)
      v[e] = (idx & s) == 0 ? (v[e] + o) * LMC_SQRT1_2 : (o - v[e]) * LMC_SQRT1_2;
  }
}

// Forward transform of levels <= WV_WARP_LEVELS levels (per level: rows,
// then columns).
__device__ __forceinline__ void wp_haar_fwd(float v[2], int lane, int levels) {
#pragma unroll
  for (int lv = 0; lv < WV_WARP_LEVELS; ++lv) {
    if (lv >= levels) break;
    wp_haar_pass(v, lane, 1 << lv, 0);
    wp_haar_pass(v, lane, 1 << lv, 1);
  }
}

// Inverse (transpose): the levels in reverse, columns then rows.
__device__ __forceinline__ void wp_haar_inv(float v[2], int lane, int levels) {
#pragma unroll
  for (int lv = WV_WARP_LEVELS - 1; lv >= 0; --lv) {
    if (lv >= levels) continue;
    wp_haar_pass(v, lane, 1 << lv, 1);
    wp_haar_pass(v, lane, 1 << lv, 0);
  }
}

// Kernel 4, Haar, warp route (wv_myula_haar's step).
template <int NQ>
__global__ void __launch_bounds__(WV_WARP_THREADS)
wv_myula_warp(float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ msk, float* __restrict__ mean,
              float* __restrict__ m2, float* __restrict__ qh,
              float* __restrict__ qn, int nx, size_t npix, int n_sq,
              int levels, int n_steps, Coef cf, Sched sc) {
  const int lane = threadIdx.x & 31;
  const int sq = blockIdx.x * (WV_WARP_THREADS / 32) + (threadIdx.x >> 5);
  if (sq >= n_sq) return;  // the whole warp
  WV_LAYER(npix, NQ);
  const uint32_t chain = lmc_sched_chain(sc);
  const float c_keep = cf.c[0], c_grad = cf.c[1], c_prox = cf.c[2];
  const float noise_amp = cf.c[3], sig = cf.c[4], thr = cf.c[5];
  int kk[2];
  float xv[2], yv[2], mv[2], sm[2];
  PixelStats<NQ, 2> st;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    kk[e] = wp_pixel(sq, lane, e, nx);
    xv[e] = x[kk[e]];
    yv[e] = y[kk[e]];
    mv[e] = msk[kk[e]];
    sm[e] = sig * mv[e];
  }
  stats_load(st, kk, mean, m2, qh, qn, npix, sc);

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
    float v[2] = {xv[0], xv[1]};
    wp_haar_fwd(v, lane, levels);
    v[0] = soft(v[0], thr);
    v[1] = soft(v[1], thr);
    wp_haar_inv(v, lane, levels);
    const StepW sw = lmc_step_w(sc, g);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float grad = sm[e] * (mv[e] * xv[e] - yv[e]);
      float xn = c_keep * xv[e] - c_grad * grad + c_prox * v[e];
      if (sc.with_noise)
        xn = xn + noise_amp * lmc_normal(sc.seed, chain, (uint32_t)kk[e],
                                         (uint32_t)g);
      xv[e] = xn;
      stats_record(st, e, xn, sc, sw);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) x[kk[e]] = xv[e];
  stats_store(st, kk, mean, m2, qh, qn, npix, sc);
}

// Kernel 5, Haar, warp route (wv_ulpda_haar's step).
template <int NQ>
__global__ void __launch_bounds__(WV_WARP_THREADS)
wv_ulpda_warp(float* __restrict__ x, float* __restrict__ c,
              float* __restrict__ xbar, const float* __restrict__ y,
              const float* __restrict__ msk, float* __restrict__ mean,
              float* __restrict__ m2, float* __restrict__ qh,
              float* __restrict__ qn, int nx, size_t npix, int n_sq,
              int levels, int n_steps, int gfirst, Coef cf, Sched sc) {
  const int lane = threadIdx.x & 31;
  const int sq = blockIdx.x * (WV_WARP_THREADS / 32) + (threadIdx.x >> 5);
  if (sq >= n_sq) return;  // the whole warp
  WV_LAYER(npix, NQ);
  c = lmc_layer(c, npix);
  xbar = lmc_layer(xbar, npix);
  const uint32_t chain = lmc_sched_chain(sc);
  const float tau = cf.c[0], mu = cf.c[1], theta = cf.c[2];
  const float noise_amp = cf.c[3], ts = cf.c[4], g_sigma = cf.c[5];
  int kk[2];
  float xv[2], cv[2], xb[2], atb[2], den[2];
  PixelStats<NQ, 2> st;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    kk[e] = wp_pixel(sq, lane, e, nx);
    xv[e] = x[kk[e]];
    cv[e] = c[kk[e]];
    // gfirst = 0 never reads the incoming xbar
    xb[e] = gfirst ? xbar[kk[e]] : xv[e];
    const float m = msk[kk[e]];
    atb[e] = ts * m * y[kk[e]];
    den[e] = 1.0f / (1.0f + ts * m);
  }
  stats_load(st, kk, mean, m2, qh, qn, npix, sc);

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == (gfirst != 0)) {
        // dual: c <- clip(c + mu W xbar, -g_sigma, g_sigma)
        float v[2] = {xb[0], xb[1]};
        wp_haar_fwd(v, lane, levels);
        cv[0] = clip(cv[0] + mu * v[0], g_sigma);
        cv[1] = clip(cv[1] + mu * v[1], g_sigma);
      } else {
        // primal: W^T c, the mask prox, noise, xbar, statistics
        float v[2] = {cv[0], cv[1]};
        wp_haar_inv(v, lane, levels);
        const StepW sw = lmc_step_w(sc, g);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xn = (xv[e] - tau * v[e] + atb[e]) * den[e];
          if (sc.with_noise)
            xn = xn + noise_amp * lmc_normal(sc.seed, chain,
                                             (uint32_t)kk[e], (uint32_t)g);
          xb[e] = xn + theta * (xn - xv[e]);
          xv[e] = xn;
          stats_record(st, e, xn, sc, sw);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    x[kk[e]] = xv[e];
    c[kk[e]] = cv[e];
    xbar[kk[e]] = xb[e];
  }
  stats_store(st, kk, mean, m2, qh, qn, npix, sc);
}

// --- Daubechies, passes route: one launch per (level, axis) pass ------------

enum { EPI_NONE = 0, EPI_SOFT = 1, EPI_CLIP = 2 };

// One periodic filter-bank pass at stride s along axis on the lattice where
// the other index % s == 0 (wavelet_fused.py::_db_pass); with rd(k) the
// value k s further along the axis, wrapped around the whole image:
//   analysis:  slot % 2s == 0: sum_i h[i] rd(i); == s: sum_i g[i] rd(i - 1)
//   synthesis: == 0: sum_i h[2i] rd(-2i) + g[2i] rd(1 - 2i)
//              == s: sum_i h[2i+1] rd(-2i - 1) + g[2i+1] rd(-2i)
// Other slots copy through; s = 0 copies every pixel (no level applies). The
// epilogue writes soft(v, a0) to out (EPI_SOFT), or updates the dual in place,
// c = clip(c + a0 v, a1), without writing out (EPI_CLIP). Grid layer z
// transforms chain z (lmc_chain_at: in, out and c a chain each, the
// ping-pong buffers plane-major).
__global__ void wv_db_pass(const float* __restrict__ in, float* __restrict__ out,
                           float* __restrict__ c, int ny, int nx, int s,
                           int axis, int inverse, Filt f, int epi, float a0,
                           float a1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  in = lmc_chain_at(in, ny, nx);
  out = lmc_chain_at(out, ny, nx);
  c = lmc_chain_at(c, ny, nx);
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
// statistics; grid layer z updates chain z (WV_LAYER).
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
  WV_LAYER((size_t)ny * nx, sc.n_q);
  p = lmc_chain_at(p, ny, nx);
  const float xv = x[k], m = msk[k];
  const float grad = cf.c[4] * m * (m * xv - y[k]);
  float xn = cf.c[0] * xv - cf.c[1] * grad + cf.c[2] * p[k];
  if (sc.with_noise)
    xn = xn + cf.c[3] * lmc_normal(sc.seed, lmc_sched_chain(sc), (uint32_t)k, (uint32_t)g);
  x[k] = xn;
  lmc_record_global(xn, k, (size_t)ny * nx, mean, m2, qh, qn, sc,
                    lmc_step_w(sc, g));
}

// Kernel 5's per-step primal update given p = W^T c: in place on x, xbar
// and the statistics; grid layer z updates chain z (WV_LAYER).
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
  WV_LAYER((size_t)ny * nx, sc.n_q);
  p = lmc_chain_at(p, ny, nx);
  xbar = lmc_chain_at(xbar, ny, nx);
  const float tau = cf.c[0], theta = cf.c[2], ts = cf.c[4];
  const float xv = x[k], m = msk[k];
  const float atb = ts * m * y[k];
  const float den = 1.0f / (1.0f + ts * m);
  float xn = (xv - tau * p[k] + atb) * den;
  if (sc.with_noise)
    xn = xn + cf.c[3] * lmc_normal(sc.seed, lmc_sched_chain(sc), (uint32_t)k, (uint32_t)g);
  x[k] = xn;
  xbar[k] = xn + theta * (xn - xv);
  lmc_record_global(xn, k, (size_t)ny * nx, mean, m2, qh, qn, sc,
                    lmc_step_w(sc, g));
}

// The forward (inverse = 0) or inverse transform of src through the ping-pong
// buffers, epilogue epi on the last pass (a copy pass with s = 0 when no level
// applies and an epilogue is asked for), of n_chains chains a launch (grid
// layers; src, c and each buffer chain-major). Returns the buffer holding the
// result (src itself when nothing was launched).
const float* db_transform(const float* src, float* const bufs[2], float* c,
                          int ny, int nx, int n_chains, int levels, int inverse,
                          const Filt& f, int epi, float a0, float a1,
                          cudaStream_t s) {
  const dim3 grid = lmc_grid(ny, nx, n_chains), block = lmc_block();
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

// --- Daubechies, resident route: one cooperative launch, a phase a level ----
// A level's passes (stride s = 2^lv) read and write only the lattice L_lv =
// {i % s == 0, j % s == 0}. One phase runs both passes of a level on the
// CTA's tile: the first pass (forward: axis 0; inverse: axis 1) on the
// tile's lattice points and the reach of the second beyond them (TAPS - 2
// lattice columns on the right, or rows above, wrapped around the image)
// into shared memory, then the second pass from shared memory on the tile's
// points. So a level costs one grid barrier, and the second pass reads no
// device memory. Level lv writes its field W_lv = B[lv % 2], every point of
// L_lv: the forward level the soft-thresholded coefficients (or the dual's
// clip) where they are final (off L_{lv+1}, or anywhere on the last level)
// and the next level's input on L_{lv+1}; the inverse level lv + 1 writes
// its result on L_{lv+1} into W_lv too, where the inverse level lv finds it
// beside level lv's final coefficients; the inverse level 0 is the update
// of the CTA's own pixels. Each phase reads one field and writes the other
// (a level writes only L_lv, where the field it overwrites holds nothing
// read again); a grid barrier separates the phases: 2L a step. Tiles are
// whole multiples of 2^levels, so a tile's lattice is a sub-lattice of the
// image's and the first lattice row and column are even slots.

// The value at (i, j), on the level's lattice, of one periodic filter-bank
// pass at stride s along axis (wv_db_pass's sums and rounding, the slot's
// taps chosen without a branch). The taps' wrap is a compare and add: their
// offsets stay below n (n >= TAPS s). Reads go to L2 (__ldcg): other CTAs
// wrote the field before the last grid barrier.
template <int TAPS>
__device__ __forceinline__ float rs_bank(const float* in, int ny, int nx,
                                         int i, int j, int s, int axis,
                                         int inverse, const Filt& f) {
  const int n = axis == 0 ? ny : nx;
  const int idx = axis == 0 ? i : j;
  const int odd = (idx & s) != 0;  // slot % 2s == s
  const float* base = axis == 0 ? in + j : in + (size_t)i * nx;
  const size_t stride = axis == 0 ? (size_t)nx : 1;
  auto rd = [&](int k) {
    int t = idx + k * s;
    t += t < 0 ? n : 0;
    t -= t >= n ? n : 0;
    return __ldcg(base + (size_t)t * stride);
  };
  float acc = 0.0f;
  if (!inverse) {
#pragma unroll
    for (int m = 0; m < TAPS; ++m)
      acc = acc + (odd ? f.g[m] : f.h[m]) * rd(m - odd);
  } else {
#pragma unroll
    for (int m = 0; m < TAPS / 2; ++m) {
      const float a = odd ? f.h[2 * m + 1] : f.h[2 * m];
      const float b = odd ? f.g[2 * m + 1] : f.g[2 * m];
      acc = acc + (a * rd(-2 * m - odd) + b * rd(1 - 2 * m - odd));
    }
  }
  return acc;
}

// The same pass from a row of shared memory: v[k] is the value k strides
// along the axis from the point, which is an odd slot when odd.
template <int TAPS>
__device__ __forceinline__ float rs_bank_sh(const float* v, int stride, int odd,
                                            int inverse, const Filt& f) {
  float acc = 0.0f;
  if (!inverse) {
#pragma unroll
    for (int m = 0; m < TAPS; ++m)
      acc = acc + (odd ? f.g[m] : f.h[m]) * v[(m - odd) * stride];
  } else {
#pragma unroll
    for (int m = 0; m < TAPS / 2; ++m) {
      const float a = odd ? f.h[2 * m + 1] : f.h[2 * m];
      const float b = odd ? f.g[2 * m + 1] : f.g[2 * m];
      acc = acc + (a * v[(-2 * m - odd) * stride] + b * v[(1 - 2 * m - odd) * stride]);
    }
  }
  return acc;
}

// fn(r, c, q) for each q = r nc + c < nr nc, strided over the CTA's threads
// without a division per point.
template <typename F>
__device__ __forceinline__ void rs_grid(int nr, int nc, F&& fn) {
  const int dr = blockDim.x / nc, dc = blockDim.x % nc;
  int r = threadIdx.x / nc, c = threadIdx.x % nc;
  for (int q = threadIdx.x; q < nr * nc; q += blockDim.x) {
    fn(r, c, q);
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// The shared memory of a tile's level phase: the larger of the forward's
// rows x (columns + TAPS - 2) and the inverse's (rows + TAPS - 2) x columns.
__host__ __device__ inline size_t rs_sh_floats(int ty, int tx, int taps) {
  const size_t a = (size_t)ty * (tx + taps - 2), b = (size_t)(ty + taps - 2) * tx;
  return a > b ? a : b;
}

// The forward level at stride s of the tile at (i0, j0): in's axis-0 pass on
// the tile's lattice rows and its lattice columns and TAPS - 2 more (sh),
// then the axis-1 pass from sh; out(i, j, v) for each of the tile's points.
template <int TAPS, typename Out>
__device__ __forceinline__ void rs_fwd_level(const float* in, float* sh, int ny,
                                             int nx, int i0, int j0, int ty,
                                             int tx, int s, const Filt& f,
                                             Out&& out) {
  const int nr = ty / s, nc = tx / s, ne = nc + TAPS - 2;
  rs_grid(nr, ne, [&](int r, int c, int q) {
    int j = j0 + c * s;
    j -= j >= nx ? nx : 0;
    sh[q] = rs_bank<TAPS>(in, ny, nx, i0 + r * s, j, s, 0, 0, f);
  });
  __syncthreads();
  rs_grid(nr, nc, [&](int r, int c, int) {
    out(i0 + r * s, j0 + c * s, rs_bank_sh<TAPS>(sh + r * ne + c, 1, c & 1, 0, f));
  });
}

// The inverse level at stride s (lv >= 1) of the tile at (i0, j0): in's
// axis-1 pass on the tile's lattice columns and its lattice rows and TAPS -
// 2 above them (sh), then the axis-0 pass from sh into out on the tile's
// points.
template <int TAPS>
__device__ __forceinline__ void rs_inv_level(const float* in, float* out,
                                             float* sh, int ny, int nx, int i0,
                                             int j0, int ty, int tx, int s,
                                             const Filt& f) {
  const int nr = ty / s, nc = tx / s, up = TAPS - 2;
  rs_grid(nr + up, nc, [&](int r, int c, int q) {
    int i = i0 + (r - up) * s;
    i += i < 0 ? ny : 0;
    sh[q] = rs_bank<TAPS>(in, ny, nx, i, j0 + c * s, s, 1, 1, f);
  });
  __syncthreads();
  rs_grid(nr, nc, [&](int r, int c, int) {
    out[(size_t)(i0 + r * s) * nx + j0 + c * s] =
        rs_bank_sh<TAPS>(sh + (r + up) * nc + c, nc, r & 1, 1, f);
  });
}

// The level-0 inverse's axis-1 pass of the tile at (i0, j0) into sh (every
// row of the tile and TAPS - 2 above); rs_p then gives the axis-0 pass, W^T
// of the coefficients, at the tile's pixel (r, c).
template <int TAPS>
__device__ __forceinline__ void rs_inv_rows(const float* in, float* sh, int ny,
                                            int nx, int i0, int j0, int ty,
                                            int tx, const Filt& f) {
  const int up = TAPS - 2;
  rs_grid(ty + up, tx, [&](int r, int c, int q) {
    int i = i0 + r - up;
    i += i < 0 ? ny : 0;
    sh[q] = rs_bank<TAPS>(in, ny, nx, i, j0 + c, 1, 1, 1, f);
  });
  __syncthreads();
}

template <int TAPS>
__device__ __forceinline__ float rs_p(const float* sh, int tx, int r, int c,
                                      const Filt& f) {
  return rs_bank_sh<TAPS>(sh + (r + TAPS - 2) * tx + c, tx, r & 1, 1, f);
}

// The forward transform of src, level by level into W_lv, fin(i, j, v, k)
// storing each final coefficient; a grid barrier after each level but the
// last.
template <int TAPS, typename Fin>
__device__ __forceinline__ void rs_forward(const float* src, float* const* w,
                                           float* sh, int ny, int nx, int i0,
                                           int j0, int ty, int tx, int levels,
                                           const Filt& f, Fin&& fin) {
  namespace cg = cooperative_groups;
  for (int lv = 0; lv < levels; ++lv) {
    const int s = 1 << lv;
    float* out = w[lv & 1];
    // points on the next level's lattice go on; the others are final
    const int next = lv + 1 < levels ? 2 * s - 1 : -1;
    rs_fwd_level<TAPS>(lv == 0 ? src : w[(lv - 1) & 1], sh, ny, nx, i0, j0, ty,
                       tx, s, f, [&](int i, int j, float v) {
                         const size_t k = (size_t)i * nx + j;
                         if (next >= 0 && ((i | j) & next) == 0) {
                           out[k] = v;
                         } else {
                           fin(i, j, v, out + k);
                         }
                       });
    if (lv + 1 < levels) cg::this_grid().sync();
  }
}

// The inverse transform of the W fields up to its level-0 axis-1 pass (sh,
// for rs_p); a grid barrier after each level but the last (and none before
// the first: the caller's).
template <int TAPS>
__device__ __forceinline__ void rs_inverse(float* const* w, float* sh, int ny,
                                           int nx, int i0, int j0, int ty,
                                           int tx, int levels, const Filt& f) {
  namespace cg = cooperative_groups;
  for (int lv = levels - 1; lv >= 1; --lv) {
    rs_inv_level<TAPS>(w[lv & 1], w[(lv - 1) & 1], sh, ny, nx, i0, j0, ty, tx,
                       1 << lv, f);
    cg::this_grid().sync();
  }
  rs_inv_rows<TAPS>(w[0], sh, ny, nx, i0, j0, ty, tx, f);
}

// Kernel 4, resident route: x in place (read around the tile by the next
// step's first level), B0 and B1 scratch. The thread's pixels are the tile's
// row-major indices threadIdx.x + e WV_RS_THREADS.
template <int TAPS>
__global__ void __launch_bounds__(WV_RS_THREADS, 1)
wv_rs_myula(float* x, const float* __restrict__ y,
            const float* __restrict__ msk, float* __restrict__ mean,
            float* __restrict__ m2, float* __restrict__ qh,
            float* __restrict__ qn, float* b0, float* b1, int ny, int nx,
            int ty, int tx, int levels, int n_steps, Filt f, Coef cf,
            Sched sc) {
  namespace cg = cooperative_groups;
  extern __shared__ float sh[];
  const float c_keep = cf.c[0], c_grad = cf.c[1], c_prox = cf.c[2];
  const float noise_amp = cf.c[3], sig = cf.c[4], thr = cf.c[5];
  const int i0 = blockIdx.y * ty, j0 = blockIdx.x * tx;
  const size_t npix = (size_t)ny * nx;
  // grid layer z: chain z of the launch's group, its scratch z npix floats
  // into each of B0 and B1 (plane-major)
  WV_LAYER(npix, sc.n_q);
  b0 = lmc_layer(b0, npix);
  b1 = lmc_layer(b1, npix);
  const uint32_t chain = lmc_sched_chain(sc);
  float* const w[2] = {b0, b1};
  int kk[WV_RS_PPT];
  float xv[WV_RS_PPT], yv[WV_RS_PPT], mv[WV_RS_PPT], sm[WV_RS_PPT];
  float mu[WV_RS_PPT], mm[WV_RS_PPT];
#pragma unroll
  for (int e = 0; e < WV_RS_PPT; ++e) {
    const int li = threadIdx.x + e * WV_RS_THREADS;
    kk[e] = li < ty * tx ? (i0 + li / tx) * nx + j0 + li % tx : -1;
    xv[e] = yv[e] = mv[e] = sm[e] = mu[e] = mm[e] = 0.0f;
    if (kk[e] < 0) continue;
    xv[e] = x[kk[e]];
    yv[e] = y[kk[e]];
    mv[e] = msk[kk[e]];
    sm[e] = sig * mv[e];
    if (sc.with_stats) {
      mu[e] = mean[kk[e]];
      mm[e] = m2[kk[e]];
    }
  }

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
    rs_forward<TAPS>(x, w, sh, ny, nx, i0, j0, ty, tx, levels, f,
                     [&](int, int, float v, float* o) { *o = soft(v, thr); });
    cg::this_grid().sync();
    rs_inverse<TAPS>(w, sh, ny, nx, i0, j0, ty, tx, levels, f);
    const StepW sw = lmc_step_w(sc, g);
#pragma unroll
    for (int e = 0; e < WV_RS_PPT; ++e) {
      if (kk[e] < 0) continue;
      const int li = threadIdx.x + e * WV_RS_THREADS;
      const float p = rs_p<TAPS>(sh, tx, li / tx, li % tx, f);
      const float grad = sm[e] * (mv[e] * xv[e] - yv[e]);
      float xn = c_keep * xv[e] - c_grad * grad + c_prox * p;
      if (sc.with_noise)
        xn = xn + noise_amp * lmc_normal(sc.seed, chain, (uint32_t)kk[e],
                                         (uint32_t)g);
      xv[e] = xn;
      x[kk[e]] = xn;
      if (sc.with_stats) lmc_welford(xn, &mu[e], &mm[e], sw);
      lmc_p2_global(xn, kk[e], npix, qh, qn, sc, sw);
    }
    // x is read around the tile by the next step's first level
    if (it + 1 < n_steps) cg::this_grid().sync();
  }
  if (!sc.with_stats) return;
#pragma unroll
  for (int e = 0; e < WV_RS_PPT; ++e) {
    if (kk[e] < 0) continue;
    mean[kk[e]] = mu[e];
    m2[kk[e]] = mm[e];
  }
}

// Kernel 5, resident route: the dual's truth in shared memory (CS, after the
// level phases' rows), its copy where the primal's levels read it (each
// coefficient in the W field of its level); xbar in place (read around the
// tile by the dual's first level), x and c written at the end, B0 and B1
// scratch.
template <int TAPS>
__global__ void __launch_bounds__(WV_RS_THREADS, 1)
wv_rs_ulpda(float* __restrict__ x, float* __restrict__ c, float* xbar,
            const float* __restrict__ y, const float* __restrict__ msk,
            float* __restrict__ mean, float* __restrict__ m2,
            float* __restrict__ qh, float* __restrict__ qn, float* b0,
            float* b1, int ny, int nx, int ty, int tx, int levels,
            int n_steps, int gfirst, Filt f, Coef cf, Sched sc) {
  namespace cg = cooperative_groups;
  extern __shared__ float sh[];
  float* cs = sh + rs_sh_floats(ty, tx, TAPS);
  const float tau = cf.c[0], mu_d = cf.c[1], theta = cf.c[2];
  const float noise_amp = cf.c[3], ts = cf.c[4], g_sigma = cf.c[5];
  const int i0 = blockIdx.y * ty, j0 = blockIdx.x * tx;
  const size_t npix = (size_t)ny * nx;
  // grid layer z: chain z of the launch's group, its scratch z npix floats
  // into each of B0 and B1 (plane-major)
  WV_LAYER(npix, sc.n_q);
  c = lmc_layer(c, npix);
  xbar = lmc_layer(xbar, npix);
  b0 = lmc_layer(b0, npix);
  b1 = lmc_layer(b1, npix);
  const uint32_t chain = lmc_sched_chain(sc);
  float* const w[2] = {b0, b1};
  int kk[WV_RS_PPT];
  float xv[WV_RS_PPT], atb[WV_RS_PPT], den[WV_RS_PPT];
  float mu[WV_RS_PPT], mm[WV_RS_PPT];
#pragma unroll
  for (int e = 0; e < WV_RS_PPT; ++e) {
    const int li = threadIdx.x + e * WV_RS_THREADS;
    kk[e] = li < ty * tx ? (i0 + li / tx) * nx + j0 + li % tx : -1;
    xv[e] = atb[e] = den[e] = mu[e] = mm[e] = 0.0f;
    if (kk[e] < 0) continue;
    xv[e] = x[kk[e]];
    const float cv = c[kk[e]];
    cs[li] = cv;
    if (!gfirst) {
      // the first primal reads each coefficient in the W field of its level
      const int ij = (i0 + li / tx) | (j0 + li % tx);
      int lv = 0;
      while (lv + 1 < levels && (ij & ((2 << lv) - 1)) == 0) ++lv;
      w[lv & 1][kk[e]] = cv;
    }
    const float m = msk[kk[e]];
    // L2Data(Mask).prox in closed form: (v + ts m y) / (1 + ts m)
    atb[e] = ts * m * y[kk[e]];
    den[e] = 1.0f / (1.0f + ts * m);
    if (sc.with_stats) {
      mu[e] = mean[kk[e]];
      mm[e] = m2[kk[e]];
    }
  }
  if (gfirst) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }

  // c <- clip(c + mu W xbar, -g_sigma, g_sigma), each coefficient where it
  // becomes final; ends without a barrier
  auto dual = [&]() {
    rs_forward<TAPS>(xbar, w, sh, ny, nx, i0, j0, ty, tx, levels, f,
                     [&](int i, int j, float v, float* o) {
                       const int li = (i - i0) * tx + (j - j0);
                       const float cn = clip(cs[li] + mu_d * v, g_sigma);
                       cs[li] = cn;
                       *o = cn;
                     });
  };
  // W^T c, the mask prox, noise, xbar, statistics; ends without a barrier
  auto primal = [&](long long g) {
    rs_inverse<TAPS>(w, sh, ny, nx, i0, j0, ty, tx, levels, f);
    const StepW sw = lmc_step_w(sc, g);
#pragma unroll
    for (int e = 0; e < WV_RS_PPT; ++e) {
      if (kk[e] < 0) continue;
      const int li = threadIdx.x + e * WV_RS_THREADS;
      const float p = rs_p<TAPS>(sh, tx, li / tx, li % tx, f);
      float xn = (xv[e] - tau * p + atb[e]) * den[e];
      if (sc.with_noise)
        xn = xn + noise_amp * lmc_normal(sc.seed, chain, (uint32_t)kk[e],
                                         (uint32_t)g);
      xbar[kk[e]] = xn + theta * (xn - xv[e]);
      xv[e] = xn;
      if (sc.with_stats) lmc_welford(xn, &mu[e], &mm[e], sw);
      lmc_p2_global(xn, kk[e], npix, qh, qn, sc, sw);
    }
  };

  for (int it = 0; it < n_steps; ++it) {
    const long long g = sc.step0 + it;
    if (gfirst) {
      dual();
      cg::this_grid().sync();
      primal(g);
    } else {
      primal(g);
      cg::this_grid().sync();  // the dual's first level reads xbar around the tile
      dual();
    }
    if (it + 1 < n_steps) cg::this_grid().sync();
  }
  __syncthreads();  // cs of the last dual level, written by other threads
#pragma unroll
  for (int e = 0; e < WV_RS_PPT; ++e) {
    if (kk[e] < 0) continue;
    x[kk[e]] = xv[e];
    c[kk[e]] = cs[threadIdx.x + e * WV_RS_THREADS];
    if (sc.with_stats) {
      mean[kk[e]] = mu[e];
      m2[kk[e]] = mm[e];
    }
  }
}

// Whether a ty x tx tile of the resident route fits: whole 2^levels tiles
// dividing the image, at most WV_RS_PPT pixels a thread, and every tap's
// offset below the axis length at the deepest level.
static inline bool rs_fits(int ny, int nx, int taps, int levels, int ty,
                           int tx) {
  const int t = 1 << levels;
  return levels >= 1 && ty >= t && tx >= t && ty % t == 0 && tx % t == 0 &&
         ny % ty == 0 && nx % tx == 0 &&
         (long long)ty * tx <= (long long)WV_RS_THREADS * WV_RS_PPT &&
         (ny >> (levels - 1)) >= taps && (nx >> (levels - 1)) >= taps;
}

// The cooperative launches of kernel on the tile grid with smem bytes of
// dynamic shared memory, one a group of per chains in turn (grid layer z of
// a launch is chain c0 + z of its group); args(c0) fills the argument array
// of the group starting at chain c0. Returns -1 when the card cannot hold
// every CTA of a launch at once.
template <typename K, typename Args>
static int rs_launch(K kernel, dim3 grid, int n_chains, int per, size_t smem,
                     Args&& args, cudaStream_t s) {
  int dev = 0, n_sm = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop || smem > (size_t)optin) return -1;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WV_RS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * n_sm < (long long)grid.x * grid.y * per) return -1;
  for (int c0 = 0; c0 < n_chains; c0 += per) {
    dim3 gg = grid;
    gg.z = n_chains - c0 < per ? n_chains - c0 : per;
    e = cudaLaunchCooperativeKernel((const void*)kernel, gg, dim3(WV_RS_THREADS),
                                    args(c0), smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// The route's fit and the chain axis; fills sc and f.
bool load_common(Sched* sc, Filt* f, int ny, int nx, int n_chains,
                 const unsigned int* chains, int taps, const float* filt,
                 int levels, int route, int gh, int gw, int per, int with_noise,
                 int with_stats, const float* qcoef, int n_q, int thin,
                 unsigned int seed, unsigned int chain, long long step0,
                 long long burn, long long cnt0, const float* mean,
                 const float* qh, const float* qn, float* const bufs[2]) {
  if (ny < 2 || nx < 2 || n_q < 0 || n_q > LMC_MAXQ || thin < 1 || levels < 0 ||
      n_chains < 1 || n_chains > 65535 || (n_chains > 1 && chains == nullptr))
    return false;
  bool ok = false;
  switch (route) {
    case RT_TILE:
      ok = taps == 2 && lmc_region_ok(ny, nx, gh, gw, levels);
      break;
    case RT_WARP:
      ok = taps == 2 && levels <= WV_WARP_LEVELS && ny % WV_SQ == 0 &&
           nx % WV_SQ == 0;
      break;
    case RT_RESIDENT:
      ok = (taps == 4 || taps == 8) && bufs[0] != nullptr &&
           bufs[1] != nullptr && rs_fits(ny, nx, taps, levels, gh, gw) &&
           per >= 1 && per <= n_chains;
      break;
    case RT_PASSES:
      ok = (taps == 2 || taps == 4 || taps == 8) && bufs[0] != nullptr &&
           bufs[1] != nullptr;
      break;
  }
  if (!ok) return false;
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
  sc->chains = chains;
  for (int jq = 0; jq < LMC_MAXQ; ++jq)
    for (int m = 0; m < 3; ++m) sc->qcoef[jq][m] = jq < n_q ? qcoef[3 * jq + m] : 0.0f;
  return true;
}

// Chain c0's copy of a chain-major field of floats floats a chain.
static inline float* at_chain(float* p, int c0, size_t floats) {
  return p ? p + (size_t)c0 * floats : p;
}

}  // namespace

// Kernel 4: n_steps MYULA steps of n_chains chains of one posterior in place
// on x, mean, m2 (n_chains, ny, nx), qh (n_chains, 5 n_q, ny, nx), qn
// (n_chains, 3 n_q, ny, nx) (float32, row-major, contiguous, on the current
// device). The chains share y and m; chain c draws its noise under (seed,
// chains[c]) (device, n_chains words), or (seed, chain) when chains is null
// (one chain).
//   y, m: the observation and the 0/1 mask; bufs: (2, n_chains, ny, nx)
//   scratch for the resident and passes routes, plane-major (null for the
//   Haar routes); taps 2, 4 or 8 with filt, host, 16 floats: h, then g, each
//   zero padded to 8; levels: the levels the transform applies
//   (wavelet_fused.py::dwt_levels); route (RT_*) and its geometry gh x gw:
//   the region of one CTA for "tile", the tile of one CTA for "resident",
//   unused otherwise; per: the chains a resident launch carries (the
//   launches take the chains in groups of per, in turn; 1..n_chains), unused
//   by the other routes, whose launches carry every chain as a grid layer.
//   coef: host, 6 floats [1 - tau/gamma, tau, tau/gamma,
//         noise_scale sqrt(2 tau), sig, thr].
//   qcoef: host, n_q * 3 floats (dn - 1) / 4 for the interior markers.
// Returns the cudaError_t of the launches (0 on success), or -1 on arguments
// outside the route's range or a resident grid the card cannot hold at once.
extern "C" int lmc_wavelet_block(
    float* x, const float* y, const float* m, float* mean, float* m2,
    float* qh, float* qn, float* bufs, int ny, int nx, int n_chains,
    const unsigned int* chains, int taps, const float* filt, int levels,
    int route, int gh, int gw, int per, int n_steps, int with_noise,
    int with_stats, const float* qcoef, int n_q, int thin, const float* coef,
    unsigned int seed, unsigned int chain, long long step0, long long burn,
    long long cnt0, void* stream) {
  const size_t npix = (size_t)ny * nx;
  float* const pp[2] = {bufs, bufs ? bufs + npix * n_chains : nullptr};
  Sched sc;
  Filt f;
  if (!load_common(&sc, &f, ny, nx, n_chains, chains, taps, filt, levels, route,
                   gh, gw, per, with_noise, with_stats, qcoef, n_q, thin, seed,
                   chain, step0, burn, cnt0, mean, qh, qn, pp))
    return -1;
  Coef cf;
  for (int i = 0; i < 6; ++i) cf.c[i] = coef[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (route == RT_TILE) {
    const dim3 grid(nx / gw, ny / gh, n_chains);
#define LMC_WV_MYULA(NQ)                                                     \
  wv_myula_haar<NQ><<<grid, LMC_TILE_THREADS, 0, s>>>(                       \
      x, y, m, mean, m2, qh, qn, nx, npix, gh, gw, levels, n_steps, cf, sc)
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
  if (route == RT_WARP) {
    const int n_sq = (ny / WV_SQ) * (nx / WV_SQ);
    const dim3 grid((n_sq + WV_WARP_THREADS / 32 - 1) / (WV_WARP_THREADS / 32), 1,
                    n_chains);
#define LMC_WV_MYULA(NQ)                                                     \
  wv_myula_warp<NQ><<<grid, WV_WARP_THREADS, 0, s>>>(                        \
      x, y, m, mean, m2, qh, qn, nx, npix, n_sq, levels, n_steps, cf, sc)
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
  if (route == RT_RESIDENT) {
    // the group's pointers: its first chain's fields and scratch, its words
    float *gx, *gmean, *gm2, *gqh, *gqn, *b0, *b1;
    Sched gsc = sc;
    void* args[] = {&gx, (void*)&y, (void*)&m, &gmean, &gm2, &gqh,    &gqn,
                    &b0, &b1,       &ny,       &nx,    &gh,  &gw,     &levels,
                    &n_steps,       &f,        &cf,    &gsc};
    auto group = [&](int c0) {
      gx = at_chain(x, c0, npix);
      gmean = at_chain(mean, c0, npix);
      gm2 = at_chain(m2, c0, npix);
      gqh = at_chain(qh, c0, 5 * (size_t)n_q * npix);
      gqn = at_chain(qn, c0, 3 * (size_t)n_q * npix);
      b0 = at_chain(pp[0], c0, npix);
      b1 = at_chain(pp[1], c0, npix);
      gsc.chains = chains ? chains + c0 : nullptr;
      return args;
    };
    const dim3 grid(nx / gw, ny / gh);
    const size_t smem = sizeof(float) * rs_sh_floats(gh, gw, taps);
    return taps == 4 ? rs_launch(wv_rs_myula<4>, grid, n_chains, per, smem, group, s)
                     : rs_launch(wv_rs_myula<8>, grid, n_chains, per, smem, group, s);
  }
  const dim3 grid = lmc_grid(ny, nx, n_chains), block = lmc_block();
  for (int it = 0; it < n_steps; ++it) {
    const float* c = db_transform(x, pp, nullptr, ny, nx, n_chains, levels, 0, f,
                                  EPI_SOFT, cf.c[5], 0.0f, s);
    // continue in the buffer the forward transform did not end in
    float* const inv_bufs[2] = {c == pp[0] ? pp[1] : pp[0], (float*)c};
    const float* p = db_transform(c, inv_bufs, nullptr, ny, nx, n_chains, levels, 1,
                                  f, EPI_NONE, 0.0f, 0.0f, s);
    wv_myula_update<<<grid, block, 0, s>>>(x, p, y, m, mean, m2, qh, qn, ny,
                                           nx, cf, sc, step0 + it);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Kernel 5: n_steps wavelet-dual ULPDA steps of n_chains chains in place on
// x, c, xbar, mean, m2 (n_chains, ny, nx), qh, qn (as kernel 4's) (float32,
// row-major, contiguous, on the current device); the dual c is in the
// interleaved layout. With gfirst = 0 the incoming xbar is never read; the
// outgoing one is the genuine x' + theta (x' - x).
//   coef: host, 6 floats [tau, mu, theta, noise_scale sqrt(2 tau), tau sig,
//         g_sigma]; the rest as lmc_wavelet_block.
extern "C" int lmc_ulpda_wavelet_block(
    float* x, float* c, float* xbar, const float* y, const float* m,
    float* mean, float* m2, float* qh, float* qn, float* bufs, int ny, int nx,
    int n_chains, const unsigned int* chains, int taps, const float* filt,
    int levels, int route, int gh, int gw, int per, int n_steps, int gfirst,
    int with_noise, int with_stats, const float* qcoef, int n_q, int thin,
    const float* coef, unsigned int seed, unsigned int chain, long long step0,
    long long burn, long long cnt0, void* stream) {
  const size_t npix = (size_t)ny * nx;
  float* const pp[2] = {bufs, bufs ? bufs + npix * n_chains : nullptr};
  Sched sc;
  Filt f;
  if (!load_common(&sc, &f, ny, nx, n_chains, chains, taps, filt, levels, route,
                   gh, gw, per, with_noise, with_stats, qcoef, n_q, thin, seed,
                   chain, step0, burn, cnt0, mean, qh, qn, pp))
    return -1;
  Coef cf;
  for (int i = 0; i < 6; ++i) cf.c[i] = coef[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (route == RT_TILE) {
    const dim3 grid(nx / gw, ny / gh, n_chains);
#define LMC_WV_ULPDA(NQ)                                                     \
  wv_ulpda_haar<NQ><<<grid, LMC_TILE_THREADS, 0, s>>>(                       \
      x, c, xbar, y, m, mean, m2, qh, qn, nx, npix, gh, gw, levels, n_steps, \
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
  if (route == RT_WARP) {
    const int n_sq = (ny / WV_SQ) * (nx / WV_SQ);
    const dim3 grid((n_sq + WV_WARP_THREADS / 32 - 1) / (WV_WARP_THREADS / 32), 1,
                    n_chains);
#define LMC_WV_ULPDA(NQ)                                                     \
  wv_ulpda_warp<NQ><<<grid, WV_WARP_THREADS, 0, s>>>(                        \
      x, c, xbar, y, m, mean, m2, qh, qn, nx, npix, n_sq, levels, n_steps,   \
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
  if (route == RT_RESIDENT) {
    float *gx, *gc, *gxbar, *gmean, *gm2, *gqh, *gqn, *b0, *b1;
    Sched gsc = sc;
    void* args[] = {&gx,  &gc,  &gxbar, (void*)&y, (void*)&m, &gmean,  &gm2,
                    &gqh, &gqn, &b0,    &b1,       &ny,       &nx,     &gh,
                    &gw,  &levels,      &n_steps,  &gfirst,   &f,      &cf,
                    &gsc};
    auto group = [&](int c0) {
      gx = at_chain(x, c0, npix);
      gc = at_chain(c, c0, npix);
      gxbar = at_chain(xbar, c0, npix);
      gmean = at_chain(mean, c0, npix);
      gm2 = at_chain(m2, c0, npix);
      gqh = at_chain(qh, c0, 5 * (size_t)n_q * npix);
      gqn = at_chain(qn, c0, 3 * (size_t)n_q * npix);
      b0 = at_chain(pp[0], c0, npix);
      b1 = at_chain(pp[1], c0, npix);
      gsc.chains = chains ? chains + c0 : nullptr;
      return args;
    };
    const dim3 grid(nx / gw, ny / gh);
    const size_t smem = sizeof(float) * (rs_sh_floats(gh, gw, taps) + (size_t)gh * gw);
    return taps == 4 ? rs_launch(wv_rs_ulpda<4>, grid, n_chains, per, smem, group, s)
                     : rs_launch(wv_rs_ulpda<8>, grid, n_chains, per, smem, group, s);
  }
  const dim3 grid = lmc_grid(ny, nx, n_chains), block = lmc_block();
  const float mu = cf.c[1], g_sigma = cf.c[5];
  for (int it = 0; it < n_steps; ++it) {
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == (gfirst != 0)) {
        db_transform(xbar, pp, c, ny, nx, n_chains, levels, 0, f, EPI_CLIP, mu,
                     g_sigma, s);
      } else {
        const float* p = db_transform(c, pp, nullptr, ny, nx, n_chains, levels, 1,
                                      f, EPI_NONE, 0.0f, 0.0f, s);
        wv_ulpda_update<<<grid, block, 0, s>>>(x, p, xbar, y, m, mean, m2, qh,
                                               qn, ny, nx, cf, sc, step0 + it);
      }
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
