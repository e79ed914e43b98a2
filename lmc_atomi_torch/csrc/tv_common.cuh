// Device code shared by the block kernels (myula_block.cu, ulpda_block.cu)
// and, through block_common.cuh, the tile kernels: the Neumann
// forward-difference stencils of lmc_atomi_tpu/ops/tv_pallas.py (_masks,
// fwd_y/fwd_x/div), the per-pixel Chambolle and FGP dual updates, and the
// Philox4x32-10 normal draw of lmc_atomi_torch/core/random.py.
//
// Layout: one thread per pixel of a row-major (ny, nx) float32 image; dual
// fields (py, px) live in global memory and are ping-ponged between launches,
// because a trip reads the dual on the 3x3 neighbourhood of its pixel.
// Every stencil here is bound by device-memory bytes (a few loads and one
// store per pixel per trip); the 3x3 reads of a block overlap and are served
// from L1/L2, which is what this simple design leans on.
//
// Operation order follows the torch plain versions term by term (a division
// by a host scalar included, see lmc_grad_u), and the library is compiled
// with --fmad=false, so that the kernels equal their plain versions bit for
// bit on the card; chip_smoke.py checks it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LMC_BX 32
#define LMC_BY 8

static inline dim3 lmc_block() { return dim3(LMC_BX, LMC_BY); }

// One thread per pixel; with nc > 1 one grid layer per chain (blockIdx.z,
// see lmc_chain_at).
static inline dim3 lmc_grid(int ny, int nx, int nc = 1) {
  return dim3((nx + LMC_BX - 1) / LMC_BX, (ny + LMC_BY - 1) / LMC_BY, nc);
}

// The chain axis of the one-thread-per-pixel launches: grid layer blockIdx.z
// runs chain z, whose field lies z ny nx floats past the chain-0 pointer p
// (the planes of a multi-plane scratch field are gridDim.z ny nx apart:
// plane-major); a null p (the zero dual) stays null. A field the chains
// share (atbs) takes no offset. One layer (gridDim.z = 1) is the plain
// single-chain launch. lmc_layer is the same for a field of any stride
// (floats a chain, chain-major: kernels 4-7's markers).
template <typename T>
static __device__ __forceinline__ T* lmc_layer(T* p, size_t floats) {
  return p ? p + (size_t)blockIdx.z * floats : p;
}

template <typename T>
static __device__ __forceinline__ T* lmc_chain_at(T* p, int ny, int nx) {
  return lmc_layer(p, (size_t)ny * nx);
}

// Divergence of p = (py, px) at (i, j): the negative adjoint of the forward
// difference with a zeroed last row/column. The dual is masked before the
// backward difference, so the wrapped entry contributes 0. A null dual is the
// zero field (the cold start).
static __device__ __forceinline__ float lmc_div(const float* __restrict__ py,
                                                const float* __restrict__ px,
                                                int i, int j, int ny, int nx) {
  if (py == nullptr) return 0.0f;
  const int k = i * nx + j;
  const float a = (i < ny - 1) ? py[k] : 0.0f;
  const float b = (i > 0) ? py[k - nx] : 0.0f;
  const float c = (j < nx - 1) ? px[k] : 0.0f;
  const float d = (j > 0) ? px[k - 1] : 0.0f;
  return (a - b) + (c - d);
}

// Forward differences (gy, gx) at (i, j) of u = div p - x / gamma, zero on the
// last row/column. x / gamma is taken as x * (1 / gamma) with the reciprocal
// rounded to float once, as torch does on CUDA for a tensor divided by a
// Python scalar.
static __device__ __forceinline__ void lmc_grad_u(
    const float* __restrict__ x, const float* __restrict__ py,
    const float* __restrict__ px, float inv_gamma, int i, int j, int ny,
    int nx, float* gy, float* gx) {
  const int k = i * nx + j;
  const float u = lmc_div(py, px, i, j, ny, nx) - x[k] * inv_gamma;
  *gy = 0.0f;
  *gx = 0.0f;
  if (i < ny - 1) *gy = (lmc_div(py, px, i + 1, j, ny, nx) - x[k + nx] * inv_gamma) - u;
  if (j < nx - 1) *gx = (lmc_div(py, px, i, j + 1, ny, nx) - x[k + 1] * inv_gamma) - u;
}

// One Chambolle dual trip at pixel k: p <- (p + s g) / (1 + s |g|), in the
// fused block's form (one reciprocal, two multiplies,
// myula_fused.py::_tv_prox).
static __device__ __forceinline__ void lmc_chambolle_point(
    const float* __restrict__ x, const float* __restrict__ py,
    const float* __restrict__ px, float* __restrict__ qy,
    float* __restrict__ qx, float inv_gamma, float step, int i, int j, int ny,
    int nx) {
  float gy, gx;
  lmc_grad_u(x, py, px, inv_gamma, i, j, ny, nx, &gy, &gx);
  const float mag = sqrtf(gy * gy + gx * gx);
  const int k = i * nx + j;
  const float py0 = py ? py[k] : 0.0f;
  const float px0 = px ? px[k] : 0.0f;
  const float inv = 1.0f / (1.0f + step * mag);
  qy[k] = (py0 + step * gy) * inv;
  qx[k] = (px0 + step * gx) * inv;
}

// Philox4x32-10 (Salmon et al. 2011, Random123 constants) on a counter in c.
static __device__ __forceinline__ void lmc_philox4x32_10(uint32_t c[4],
                                                         uint32_t k0,
                                                         uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Standard normal for (seed, chain, pixel, step): Box-Muller (cos branch) on
// the top 24 bits of the first two Philox words, as core/random.py::normal_field.
static __device__ __forceinline__ float lmc_normal(uint32_t seed,
                                                   uint32_t chain,
                                                   uint32_t pixel,
                                                   uint32_t step) {
  uint32_t c[4] = {pixel, step, 0u, 0u};
  lmc_philox4x32_10(c, seed, chain);
  const float u1 = (float)(int)(c[0] >> 8) * (1.0f / 16777216.0f) +
                   (0.5f / 16777216.0f);
  const float u2 = (float)(int)(c[1] >> 8) * (1.0f / 16777216.0f);
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = 6.283185307179586f * u2;
  return r * cosf(ang);
}
