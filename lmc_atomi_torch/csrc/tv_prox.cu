// Kernel 1: the Chambolle isotropic TV prox, prox of gamma * TV_iso.
//
// Replaces lmc_atomi_tpu/ops/tv_pallas.py::prox_tv_iso_pallas (_kernel), which
// keeps x and the dual in one TPU core's VMEM for all trips. Hopper has no
// such scratch, so here the image and the dual stay in global memory: each
// trip is one launch of one thread per pixel that recomputes u = div p - x/g
// at (i, j), (i+1, j) and (i, j+1) from the dual on its 3x3 neighbourhood and
// writes its new dual into the other buffer of a ping-pong pair. A last
// launch writes x - gamma div p. The trips are bound by device-memory bytes
// (~5 floats per pixel, mostly L2 hits); at 512^2 the 4 MiB working set fits
// the 50 MB L2, so one prox costs roughly niter + 1 launches of a few us each.
#include "tv_common.cuh"

namespace {

__global__ void tv_chambolle_trip(const float* __restrict__ x,
                                  const float* __restrict__ py,
                                  const float* __restrict__ px,
                                  float* __restrict__ qy,
                                  float* __restrict__ qx, int ny, int nx,
                                  float inv_gamma, float step) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  lmc_chambolle_point<false>(x, py, px, qy, qx, inv_gamma, step, i, j, ny, nx);
}

__global__ void tv_prox_finish(const float* __restrict__ x,
                               const float* __restrict__ py,
                               const float* __restrict__ px,
                               float* __restrict__ out, int ny, int nx,
                               float gamma) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int k = i * nx + j;
  out[k] = x[k] - gamma * lmc_div(py, px, i, j, ny, nx);
}

}  // namespace

// x, out: (ny, nx); d0y, d0x, d1y, d1x: (ny, nx) scratch for the dual pair.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int lmc_tv_prox_chambolle(const float* x, float* out, float* d0y,
                                     float* d0x, float* d1y, float* d1x,
                                     int ny, int nx, float gamma, int niter,
                                     float step, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = lmc_grid(ny, nx), block = lmc_block();
  const float inv_gamma = 1.0f / gamma;
  const float* py = nullptr;  // the cold start: a zero dual
  const float* px = nullptr;
  float* bufs[2][2] = {{d0y, d0x}, {d1y, d1x}};
  for (int t = 0; t < niter; ++t) {
    float* qy = bufs[t % 2][0];
    float* qx = bufs[t % 2][1];
    tv_chambolle_trip<<<grid, block, 0, s>>>(x, py, px, qy, qx, ny, nx,
                                             inv_gamma, step);
    py = qy;
    px = qx;
  }
  tv_prox_finish<<<grid, block, 0, s>>>(x, py, px, out, ny, nx, gamma);
  return (int)cudaGetLastError();
}
