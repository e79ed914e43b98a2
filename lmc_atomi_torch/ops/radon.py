"""Parallel-beam Radon transform and filtered backprojection (counterpart of
``lmc_atomi_tpu/ops/radon.py``).

Projection samples the image along rotated rays (``n_det`` detector bins,
``n_det`` samples a ray, unit spacing, ``n_det = max(ny, nx)``); the
adjoint is the backprojection. Three modes compute the same operator:

- **dense**: the exact bilinear-footprint matrix ``(n_angles n_det, ny nx)``,
  built once on the host in numpy; ``matvec`` and ``rmatvec`` are one
  matrix-vector product each, in IEEE float32 on the card (TF32 would be a
  ~1e-3 relative error). ``create`` picks it while the matrix fits
  ``_DENSE_BUDGET_BYTES`` (128^2 at 30 angles: 251.7 MB float32).
- **shear**: each angle is an exact ``rot90`` pre-rotation of the 2x
  zero-padded image (angles grouped by quadrant) and the residual rotation
  ``|phi| <= 45`` degrees as the Paeth shears ``Sx(tan(phi/2)) Sy(-sin phi)
  Sx(tan(phi/2))``, each a batched FFT along one axis, a phase ramp and the
  inverse FFT (spectral, periodic-sinc interpolation); a projection sums
  the rotated image along its columns and keeps the central ``n`` bins. A
  shear along the summed axis keeps every line's sum (its zero-frequency
  bin, where the ramp is 1), so the projection skips the last shear: the
  same operator with a third fewer transforms. The adjoint runs the
  conjugate ramps in reverse, ``rot90(+k)`` and the crop of the pad. No
  matrix is built; ``create`` picks it above the dense budget.
- **gather**: bilinear interpolation (``map_coordinates(order=1,
  mode="constant", cval=0)``) on the same footprint as the dense matrix,
  the forward a gather and sum, the adjoint a gather over each pixel's
  padded list of contributions: a fixed-order sum, so two calls give the
  same bits on the card (a scatter-add would sum with atomics).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lmc_atomi_torch.ops.linops import LinOp, _vdot

__all__ = ["Radon2D", "fbp"]

_DENSE_BUDGET_BYTES = 512 * 1024 * 1024


def _footprint_coo(shape, thetas, n_det):
    """COO triplets ``(angle * n_det + t, pixel, bilinear weight)`` of every
    sample point of every ray, in float64 on the host."""
    ny, nx = shape
    c0, c1 = (ny - 1.0) / 2.0, (nx - 1.0) / 2.0
    t = np.arange(n_det, dtype=np.float64) - (n_det - 1.0) / 2.0
    s = np.arange(n_det, dtype=np.float64) - (n_det - 1.0) / 2.0
    tidx = np.broadcast_to(np.arange(n_det)[None, :], (n_det, n_det))
    out_r, out_c, out_w = [], [], []
    for a, th in enumerate(np.asarray(thetas, np.float64)):
        ct, st = np.cos(th), np.sin(th)
        yy = c0 + t[None, :] * ct + s[:, None] * (-st)  # (s, t)
        xx = c1 + t[None, :] * st + s[:, None] * ct
        iy = np.floor(yy).astype(np.int64)
        ix = np.floor(xx).astype(np.int64)
        fy = yy - iy
        fx = xx - ix
        for dy in (0, 1):
            for dx in (0, 1):
                py = iy + dy
                px = ix + dx
                w = (fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)
                ok = (py >= 0) & (py < ny) & (px >= 0) & (px < nx)
                out_r.append(a * n_det + tidx[ok])
                out_c.append((py * nx + px)[ok])
                out_w.append(w[ok])
    return (np.concatenate(out_r).astype(np.int32), np.concatenate(out_c).astype(np.int32),
            np.concatenate(out_w))


def _dense_matrix(shape, thetas, n_det, dtype=torch.float32, device=None):
    """The projection matrix ``(n_angles n_det, ny nx)`` assembled on the
    host, one weighted bincount of the COO triplets per angle."""
    ny, nx = shape
    thetas_np = np.asarray(thetas, np.float64)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = np.zeros((len(thetas_np) * n_det, ny * nx), np_dtype)
    for a in range(len(thetas_np)):
        r, c, w = _footprint_coo(shape, thetas_np[a:a + 1], n_det)
        out[a * n_det:(a + 1) * n_det] = np.bincount(
            r.astype(np.int64) * (ny * nx) + c, weights=w,
            minlength=n_det * ny * nx).reshape(n_det, ny * nx)
    return torch.from_numpy(out).to(device)


def _angles(n_angles: int, dtype, device=None):
    """``n_angles`` angles from 0 to pi (pi left out): ``i * (pi *
    (1 / n_angles))`` with each product rounded to ``dtype``, the JAX
    package's ``jnp.linspace(0, pi, n_angles, endpoint=False, dtype)`` as
    XLA evaluates it on the CPU."""
    one = torch.ones((), dtype=dtype, device=device)
    step = torch.tensor(math.pi, dtype=dtype, device=device) * (one / n_angles)
    return torch.arange(n_angles, dtype=dtype, device=device) * step


def _ramp(shifts, k, along_rows: bool):
    """The shear's phase ramp ``exp(2 pi i shift k)`` for a batch of angles:
    ``shifts`` (B, m) indexed by the line, ``k`` the FFT frequencies. Along
    the rows (``_shear_fft``'s axis 1) entry ``[b, v, w]`` takes
    ``shifts[b, v] k[w]``, along the columns (axis 0) ``k[v] shifts[b, w]``."""
    if along_rows:
        ang = 2.0 * math.pi * (shifts[:, :, None] * k[None, None, :])
    else:
        ang = 2.0 * math.pi * (k[None, :, None] * shifts[:, None, :])
    return torch.polar(torch.ones_like(ang), ang)


@dataclass
class _ShearGroup:
    k: int  # rot90 quadrant
    idx: torch.Tensor  # the group's angle indices
    e_rows: torch.Tensor  # (B, m, m) ramp of the shears along the rows
    e_cols: torch.Tensor  # (B, m, m) ramp of the shear along the columns


@dataclass
class _GatherPlan:
    pix: torch.Tensor  # (A, S, T, 4) flat pixel of each corner (0 where outside)
    w: torch.Tensor  # (A, S, T, 4) its bilinear weight (0 where outside)
    t_ray: torch.Tensor  # (ny nx, K) ray rows of each pixel's contributions
    t_w: torch.Tensor  # (ny nx, K) their weights, 0 past the pixel's count


@dataclass
class Radon2D(LinOp):
    thetas: torch.Tensor  # (n_angles,) radians
    dense: Optional[torch.Tensor] = None  # (n_angles n_det, ny nx) or None
    shape: tuple = (0, 0)
    mode: str = "gather"
    shear_phis: Optional[torch.Tensor] = None  # (n_angles,) residual angles
    shear_ks: tuple = ()
    _plan: object = field(default=None, init=False, repr=False, compare=False)

    @classmethod
    def create(cls, shape, n_angles: int = 90, dtype=torch.float32,
               dense: Optional[bool] = None, mode: Optional[str] = None,
               device=None) -> "Radon2D":
        """``mode=None`` picks "dense" while the matrix fits
        ``_DENSE_BUDGET_BYTES``, else "shear"; ``dense`` is the boolean
        override (True: "dense", False: "gather")."""
        thetas = _angles(n_angles, dtype, device)
        ny, nx = shape
        n_det = max(ny, nx)
        nbytes = n_angles * n_det * ny * nx * dtype.itemsize
        if mode is None:
            if dense is not None:
                mode = "dense" if dense else "gather"
            else:
                mode = "dense" if nbytes <= _DENSE_BUDGET_BYTES else "shear"
        if mode not in ("dense", "shear", "gather"):
            raise ValueError(f"unknown Radon mode {mode!r}")
        mat = phis = None
        ks = ()
        th = thetas.detach().cpu().numpy().astype(np.float64)
        if mode == "dense":
            mat = _dense_matrix(shape, th, n_det, dtype, device)
        elif mode == "shear":
            k = np.round(th / (np.pi / 2.0)).astype(int)
            phis = torch.as_tensor(th - k * (np.pi / 2.0), dtype=dtype, device=device)
            ks = tuple(int(i) for i in k)
        return cls(thetas=thetas, dense=mat, shape=tuple(shape), mode=mode,
                   shear_phis=phis, shear_ks=ks)

    @property
    def n_det(self) -> int:
        return max(self.shape)

    # -- shear ---------------------------------------------------------------

    def _shear_groups(self):
        """The angle groups by quadrant with their ramps, built once."""
        if self._plan is None:
            n = self.shape[0]
            if self.shape[1] != n:
                raise ValueError("shear-FFT Radon needs a square image")
            m = 2 * n
            phis = self.shear_phis
            dt, dev = phis.dtype, phis.device
            u = torch.arange(m, dtype=dt, device=dev) - (m - 1.0) / 2.0
            kf = torch.fft.fftfreq(m, dtype=dt, device=dev)
            groups = []
            for k in sorted(set(self.shear_ks)):
                idx = torch.tensor([i for i, kk in enumerate(self.shear_ks) if kk == k],
                                   device=dev)
                p = phis[idx]
                a = torch.tan(p / 2.0)
                b = -torch.sin(p)
                groups.append(_ShearGroup(
                    k=k, idx=idx,
                    e_rows=_ramp(a[:, None] * u[None, :], kf, True),
                    e_cols=_ramp(b[:, None] * u[None, :], kf, False)))
            self._plan = groups
        return self._plan

    def _project_shear(self, x):
        n = self.shape[0]
        m, pad = 2 * n, n // 2
        xp = torch.zeros((m, m), dtype=x.dtype, device=x.device)
        xp[pad:pad + n, pad:pad + n] = x
        out = torch.empty((len(self.shear_ks), n), dtype=x.dtype, device=x.device)
        for g in self._shear_groups():
            xf = torch.fft.fft(torch.rot90(xp, -g.k, (0, 1)), dim=-1)
            z = torch.fft.ifft(xf[None] * g.e_rows, dim=-1).real
            z = torch.fft.ifft(torch.fft.fft(z, dim=-2) * g.e_cols, dim=-2).real
            out[g.idx] = z.sum(dim=-1)[:, pad:pad + n]
        return out

    def _backproject_shear(self, sino):
        n = self.shape[0]
        m, pad = 2 * n, n // 2
        xp = torch.zeros((m, m), dtype=sino.dtype, device=sino.device)
        for g in self._shear_groups():
            yp = torch.zeros((len(g.idx), m), dtype=sino.dtype, device=sino.device)
            yp[:, pad:pad + n] = sino[g.idx]
            # a line constant along the summed axis: its column FFT is the
            # detector line's, on every column
            z = torch.fft.ifft(torch.fft.fft(yp, dim=-1)[:, :, None] * g.e_cols.conj(),
                               dim=-2).real
            zf = (torch.fft.fft(z, dim=-1) * g.e_rows.conj()).sum(dim=0)
            xp = xp + torch.rot90(torch.fft.ifft(zf, dim=-1).real, g.k, (0, 1))
        return xp[pad:pad + n, pad:pad + n]

    # -- gather --------------------------------------------------------------

    def _gather_plan(self) -> _GatherPlan:
        """Every sample point's four corners and weights, computed as
        ``map_coordinates`` does in the angles' dtype, and their transpose:
        each pixel's contributions, padded to the largest count."""
        if self._plan is None:
            ny, nx = self.shape
            n_det = self.n_det
            th = self.thetas
            dt, dev = th.dtype, th.device
            c = (torch.tensor([ny, nx], dtype=dt, device=dev) - 1.0) / 2.0
            t = torch.arange(n_det, dtype=dt, device=dev) - (n_det - 1.0) / 2.0
            s = t
            ct, st = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
            yy = c[0] + t[None, None, :] * ct + s[None, :, None] * (-st)  # (A, S, T)
            xx = c[1] + t[None, None, :] * st + s[None, :, None] * ct
            corners = []
            for coord, size in ((yy, ny), (xx, nx)):
                lower = torch.floor(coord)
                upper_w = coord - lower
                index = lower.to(torch.int64)
                corners.append(((index, 1 - upper_w), (index + 1, upper_w)))
            pix, w, valid = [], [], []
            for iy, wy in corners[0]:
                for ix, wx in corners[1]:
                    ok = (iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)
                    pix.append(torch.where(ok, iy * nx + ix, 0))
                    w.append(torch.where(ok, wy * wx, 0.0))
                    valid.append(ok)
            pix, w, valid = torch.stack(pix, -1), torch.stack(w, -1), torch.stack(valid, -1)
            # the transpose: the corners inside the image sorted by pixel,
            # each pixel's run of contributions laid out in one padded row
            ray = torch.arange(len(th) * n_det, device=dev).reshape(len(th), 1, n_det, 1)
            ok = valid.reshape(-1)
            ray = ray.expand(pix.shape).reshape(-1)[ok]
            p_flat, w_flat = pix.reshape(-1)[ok], w.reshape(-1)[ok]
            order = torch.argsort(p_flat, stable=True)
            p_flat, w_flat, ray = p_flat[order], w_flat[order], ray[order]
            counts = torch.bincount(p_flat, minlength=ny * nx)
            start = torch.cumsum(counts, 0) - counts
            slot = torch.arange(p_flat.numel(), device=dev) - start[p_flat]
            width = max(int(counts.max()), 1)
            t_ray = torch.zeros((ny * nx, width), dtype=torch.int64, device=dev)
            t_w = torch.zeros((ny * nx, width), dtype=dt, device=dev)
            t_ray[p_flat, slot] = ray
            t_w[p_flat, slot] = w_flat
            self._plan = _GatherPlan(pix=pix, w=w, t_ray=t_ray, t_w=t_w)
        return self._plan

    def _project_gather(self, x):
        g = self._gather_plan()
        vals = (x.reshape(-1)[g.pix] * g.w).sum(dim=-1)  # (A, S, T)
        return vals.sum(dim=1)

    def _backproject_gather(self, sino):
        g = self._gather_plan()
        return (sino.reshape(-1)[g.t_ray] * g.t_w).sum(dim=1).reshape(self.shape)

    # -- the operator --------------------------------------------------------

    def _check_dense(self):
        if self.dense.is_cuda and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("the dense Radon projector needs IEEE float32 matmuls: "
                               "torch.set_float32_matmul_precision('highest')")

    def matvec(self, x):
        if self.mode == "shear":
            return self._project_shear(x)
        if self.dense is not None:
            self._check_dense()
            return (self.dense @ x.reshape(-1)).reshape(len(self.thetas), -1)
        return self._project_gather(x)

    def rmatvec(self, sino):
        if self.mode == "shear":
            return self._backproject_shear(sino)
        if self.dense is not None:
            self._check_dense()
            return (sino.reshape(-1) @ self.dense).reshape(self.shape)
        return self._backproject_gather(sino)


def fbp(op: Radon2D, sino, filter_name: str = "ramp", calibrate: bool = True):
    """Filtered backprojection: the sinogram filtered along the detector by
    the real-space bandlimited ramp (Kak & Slaney eq. 61; its DC is small and
    positive, so the projections keep their means) on a 2x zero pad, with
    Hann apodization for ``filter_name="hann"``, backprojected through the
    operator's adjoint and scaled by ``pi / (2 n_angles)``. ``calibrate``
    then fits ``a x + b`` to the sinogram by least squares (the 2 x 2 normal
    system of ``A x`` and ``A 1``): ``a`` fixes the discrete adjoint's
    normalisation, ``b`` the DC pedestal the ramp cannot represent. Works in
    every mode of ``Radon2D``."""
    n_angles, n_det = sino.shape
    m = 1
    while m < 2 * n_det:
        m *= 2
    idx = np.concatenate([np.arange(m // 2 + 1), np.arange(m // 2 - 1, 0, -1)])
    h = np.zeros(m)
    h[0] = 0.25
    odd = idx % 2 == 1
    h[odd] = -1.0 / (np.pi * idx[odd]) ** 2
    dt, dev = sino.dtype, sino.device
    filt = 2.0 * torch.as_tensor(np.real(np.fft.rfft(h)), dtype=dt, device=dev)
    if filter_name == "hann":
        f = torch.fft.rfftfreq(m, dtype=dt, device=dev)
        filt = filt * (0.5 + 0.5 * torch.cos(2.0 * math.pi * f))
    elif filter_name != "ramp":
        raise ValueError(f"unknown FBP filter {filter_name!r}")
    pad = torch.zeros((n_angles, m), dtype=dt, device=dev)
    pad[:, :n_det] = sino
    sf = torch.fft.irfft(torch.fft.rfft(pad, dim=1) * filt[None, :], n=m, dim=1)[:, :n_det]
    x = op.rmatvec(sf) * (math.pi / (2.0 * n_angles))
    if calibrate:
        ax = op.matvec(x)
        a1 = op.matvec(torch.ones_like(x))
        g11, g12, g22 = _vdot(ax, ax), _vdot(ax, a1), _vdot(a1, a1)
        r1, r2 = _vdot(ax, sino), _vdot(a1, sino)
        det = torch.clamp(g11 * g22 - g12 * g12, min=1e-30)
        a = (g22 * r1 - g12 * r2) / det
        b = (g11 * r2 - g12 * r1) / det
        x = a * x + b
    return x
