// Kernels 1 and 8: the Chambolle isotropic TV prox on halo tiles of the
// image, and one MYULA step built on it.
//
// Kernel 1 replaces lmc_atomi_tpu/ops/tv_pallas.py::prox_tv_iso_pallas
// (_kernel), which keeps x and the dual in one TPU core's VMEM for all trips.
// Kernel 8 replaces lmc_atomi_tpu/kernels/myula_pallas.py::
// myula_tv_fused_update (_kernel): the same cold prox, then the MYULA update
// x' = c_keep x - c_grad grad + c_prox prox + noise_amp xi from a given data
// gradient, xi the Philox normal at the global pixel and step.
//
// Both are one kernel template, tv_prox_tile<kTail, kFree>. A CTA owns an
// interior of ty x tx pixels and holds its tile, grown by a halo h in rows
// and columns (block_common.cuh, "halo tiles"), in shared memory: x, u and
// the dual. The niter trips run in segments of at most k: from a cold (zero)
// or a loaded dual, trip tr of a segment of kk computes u once per pixel and
// then the dual on the interior grown by kk - tr (rs_trips, kernel 1's two
// divisions), so the interior's dual is exact after the segment if h >= k + 1.
// After the last segment each CTA writes x - gamma div p on its interior,
// with kTail the update and the noise instead. Between segments each CTA
// writes its interior's dual to one of two parity buffers in device memory
// and reloads its whole tile's dual at L2 (__ldcg). The host's planner
// (ops/tv_cuda.py::prox_plan) names the interior, the CTA size, k and the
// route, which only changes what lies between two segments:
//   cone:     k = niter, one plain launch, no dual in device memory;
//   resident: every tile resident at once, one cooperative launch with a
//             grid barrier between two segments (512^2);
//   launches: one plain launch a segment (a niter whose cone does not fit).
// A tile clear of image row ny - 1 and column nx - 1 runs the mask-free
// instantiation (kFree), decided once per CTA.
//
// Every interior pixel takes the plain versions' operations in their order
// (ops/tv_cuda.py::prox_tv_iso_ref, kernels/myula_cuda.py::
// myula_tv_fused_update_ref), so with --fmad=false the kernels equal them bit
// for bit. They are bound by instruction issue in the trips (two passes a
// trip over the cone, an IEEE square root and two divisions a pixel, a CTA
// barrier after each pass); device memory sees x in, the prox or x' out
// (and the gradient in), plus the dual exchanges.
#include <cooperative_groups.h>

#include "block_common.cuh"

namespace {

// The launcher's route codes (ops/tv_cuda.py: ROUTES).
enum { ROUTE_CONE = 0, ROUTE_RESIDENT = 1, ROUTE_LAUNCHES = 2 };

struct ProxTile {
  float tv_gamma, inv_tv_gamma, tv_step;
  float c_keep, c_grad, c_prox, noise_amp;  // kernel 8's update
  int fgp;                                  // 0: rs_trips runs Chambolle trips
  int niter, k, ty, tx, h, with_noise;
  uint32_t seed, chain, g;
};

__host__ __device__ inline int tv_segments(int niter, int k) {
  return k > 0 ? (niter + k - 1) / k : 1;
}

// Segments [s0, s1) of one CTA's prox on tile t, kFree on an edge-free tile;
// the dual of segment s goes out through dual + 2 (s % 2) npix (y, then x
// plane) and comes back in for segment s + 1. With s1 > s0 + 1 the grid is
// cooperative and waits at a barrier between two segments.
template <bool kTail, bool kFree>
__device__ __forceinline__ void tv_prox_tile(
    const float* __restrict__ x, const float* __restrict__ grad,
    float* __restrict__ out, float* dual, const ProxTile& p, int s0, int s1,
    float* X, float* U, float* PY, float* PX, const TileGeo& t) {
  const size_t npix = (size_t)t.ny * t.nx;
  // x where the trips read it: the interior grown by k
  rs_rect(rs_grown(t, p.k), t.sx, [&](int li, int r, int c) {
    X[li] = x[lmc_tile_k(r, c, t)];
  });
  const int n_seg = tv_segments(p.niter, p.k);
  for (int s = s0; s < s1; ++s) {
    const float* in = s > 0 ? dual + (size_t)(2 * ((s - 1) & 1)) * npix : nullptr;
    const int kk = p.niter - s * p.k < p.k ? p.niter - s * p.k : p.k;
    rs_trips<kFree, false>(p, X, U, PY, PX, nullptr, nullptr, in,
                           in ? in + npix : nullptr, p.inv_tv_gamma, kk, nullptr,
                           t);
    if (s + 1 < n_seg) {
      float* o = dual + (size_t)(2 * (s & 1)) * npix;
      for (int li = threadIdx.x; li < p.ty * p.tx; li += blockDim.x) {
        int lt, r, c;
        size_t k;
        if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
        o[k] = PY[lt];
        o[npix + k] = PX[lt];
      }
      if (s + 1 < s1) cooperative_groups::this_grid().sync();
      continue;
    }
    for (int li = threadIdx.x; li < p.ty * p.tx; li += blockDim.x) {
      int lt, r, c;
      size_t k;
      if (!lmc_tile_inner(li, t, &lt, &r, &c, &k)) continue;
      const float xv = X[lt];
      const float prox = xv - p.tv_gamma * lmc_tile_div<kFree>(PY, PX, lt, r, c, t);
      if (kTail) {
        float xn = p.c_keep * xv - p.c_grad * grad[k] + p.c_prox * prox;
        if (p.with_noise) {
          xn = xn + p.noise_amp * lmc_normal(p.seed, p.chain, (uint32_t)k, p.g);
        }
        out[k] = xn;
      } else {
        out[k] = prox;
      }
    }
  }
}

// One launch of segments [s0, s1). An SM runs 1024 threads of it (two CTAs
// of 512 or one of 1024), at most 64 registers a thread. Dynamic shared
// memory: x, u and the dual (y, x) on the tile, then the gr/gc indices.
template <bool kTail, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
tv_prox_kernel(const float* __restrict__ x, const float* __restrict__ grad,
               float* __restrict__ out, float* dual, int ny, int nx,
               ProxTile p, int s0, int s1) {
  extern __shared__ float sm[];
  const int n = (p.ty + 2 * p.h) * (p.tx + 2 * p.h);
  float* X = sm;
  float* U = X + n;
  float* PY = U + n;
  float* PX = PY + n;
  const TileGeo t = lmc_tile_geo((int*)(PX + n), ny, nx, p.ty, p.tx, p.h);
  __syncthreads();
  if (lmc_tile_free(t)) {
    tv_prox_tile<kTail, true>(x, grad, out, dual, p, s0, s1, X, U, PY, PX, t);
  } else {
    tv_prox_tile<kTail, false>(x, grad, out, dual, p, s0, s1, X, U, PY, PX, t);
  }
}

size_t tv_smem_bytes(int ty, int tx, int h) {
  const size_t sy = ty + 2 * h, sx = tx + 2 * h;
  return sizeof(float) * 4 * sy * sx + sizeof(int) * (sy + sx);
}

}  // namespace

// Kernel 1 (tail 0): out = prox of gamma TV at x, niter cold Chambolle trips
// at step. Kernel 8 (tail 1): out = one MYULA step of x given grad, the noise
// (with_noise) the Philox normal at (seed, chain, pixel, g). x, grad, out:
// (ny, nx) float32, row-major, contiguous, on the current device; grad is
// read only with tail. coef: host, 5 floats [gamma, 1 - tau/gamma, tau,
// tau/gamma, noise_scale sqrt(2 tau)] (the last four for tail only).
// route, ty, tx, k, threads: the plan of ops/tv_cuda.py::prox_plan (ROUTES
// order; k = 0 iff niter = 0); the halo is k + 1. dual: with more than one
// segment, 2 (y, x) planes of (ny, nx) scratch, 4 with more than two; may be
// null otherwise. Returns the cudaError_t of the launches (0 on success), or
// -1 on arguments outside the supported range, a tile that does not fit the
// card's shared memory, or a resident grid whose tiles are not all resident.
extern "C" int lmc_tv_prox(const float* x, const float* grad, float* out,
                           float* dual, int ny, int nx, int niter, float step,
                           const float* coef, int tail, int with_noise,
                           unsigned int seed, unsigned int chain,
                           unsigned int g, int route, int ty, int tx, int k,
                           int threads, void* stream) {
  if (ny < 2 || nx < 2 || niter < 0 || k < 0 || k > niter ||
      (k == 0) != (niter == 0) || ty < 1 || tx < 1 ||
      (threads != 512 && threads != 1024) || route < ROUTE_CONE ||
      route > ROUTE_LAUNCHES)
    return -1;
  const int n_seg = tv_segments(niter, k);
  if ((route == ROUTE_CONE && n_seg != 1) ||
      (route == ROUTE_LAUNCHES && n_seg == 1) || (n_seg > 1 && dual == nullptr))
    return -1;
  ProxTile p;
  p.tv_gamma = coef[0];
  // x / gamma as x * (1 / gamma), the reciprocal of the float gamma, as torch
  // divides a CUDA tensor by a Python scalar
  p.inv_tv_gamma = 1.0f / coef[0];
  p.tv_step = step;
  p.c_keep = coef[1];
  p.c_grad = coef[2];
  p.c_prox = coef[3];
  p.noise_amp = coef[4];
  p.fgp = 0;
  p.niter = niter;
  p.k = k;
  p.ty = ty;
  p.tx = tx;
  p.h = k + 1;
  p.with_noise = with_noise;
  p.seed = seed;
  p.chain = chain;
  p.g = g;
  int dev = 0, n_sm = 0, optin = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tv_smem_bytes(ty, tx, p.h);
  if (smem > (size_t)optin) return -1;
  void (*fn)(const float*, const float*, float*, float*, int, int, ProxTile,
             int, int) =
      tail ? (threads == 512 ? tv_prox_kernel<true, 512> : tv_prox_kernel<true, 1024>)
           : (threads == 512 ? tv_prox_kernel<false, 512> : tv_prox_kernel<false, 1024>);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == ROUTE_RESIDENT) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (!coop || (long long)per_sm * n_sm < (long long)grid.x * grid.y) return -1;
    int s0 = 0, s1 = n_seg;
    void* args[] = {(void*)&x, (void*)&grad, &out, &dual, &ny, &nx, &p, &s0, &s1};
    e = cudaLaunchCooperativeKernel((const void*)fn, grid, dim3(threads), args,
                                    smem, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  for (int sg = 0; sg < n_seg; ++sg) {
    fn<<<grid, threads, smem, s>>>(x, grad, out, dual, ny, nx, p, sg, sg + 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
