"""Streaming statistics (counterpart of ``lmc_atomi_tpu/core/stats.py``).

* ``RunningMoments`` - weighted Welford mean/variance with the Chan et al.
  parallel ``merge``.
* ``RunningQuantile`` - vectorized P^2 quantile estimator (Jain & Chlamtac
  1985) for per-pixel credible intervals without storing samples.

Counts are Python ints (the port's runners drive the chain from the host);
the fields are tensors of one shape.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["RunningMoments", "RunningQuantile"]


@dataclass
class RunningMoments:
    """Welford online mean/variance of one tensor."""

    count: int
    mean: torch.Tensor
    m2: torch.Tensor

    @classmethod
    def init(cls, example: torch.Tensor) -> "RunningMoments":
        return cls(count=0, mean=torch.zeros_like(example),
                   m2=torch.zeros_like(example))

    def update(self, x: torch.Tensor, weight=None) -> "RunningMoments":
        """Add one observation. ``weight`` optionally masks it (0 or 1)."""
        w = 1 if weight is None else int(weight)
        new_count = self.count + w
        denom = float(max(new_count, 1))
        delta = x - self.mean
        mean = self.mean + float(w) * delta / denom
        m2 = self.m2 + float(w) * delta * (x - mean)
        return RunningMoments(count=new_count, mean=mean, m2=m2)

    def merge(self, other: "RunningMoments") -> "RunningMoments":
        """Chan et al. parallel combine of two partial results."""
        na, nb = self.count, other.count
        n = na + nb
        nf = float(max(n, 1))
        delta = other.mean - self.mean
        mean = self.mean + delta * float(nb) / nf
        m2 = self.m2 + other.m2 + delta * delta * float(na) * float(nb) / nf
        return RunningMoments(count=n, mean=mean, m2=m2)

    @property
    def variance(self) -> torch.Tensor:
        return self.m2 / float(max(self.count - 1, 1))

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.variance)


@dataclass
class RunningQuantile:
    """Vectorized P^2 streaming ``p``-quantile over tensors of one shape.

    Five markers per element (heights and 1-based positions); after >= 5
    updates ``value`` approximates the running quantile.
    """

    p: float
    count: int
    heights: torch.Tensor  # (5, *shape)
    positions: torch.Tensor  # (5, *shape)

    @classmethod
    def init(cls, shape, p: float, dtype=torch.float32,
             device=None) -> "RunningQuantile":
        shape = tuple(shape)
        pos = torch.arange(1.0, 6.0, dtype=dtype, device=device)
        return cls(
            p=float(p),
            count=0,
            heights=torch.zeros((5,) + shape, dtype=dtype, device=device),
            positions=pos.reshape((5,) + (1,) * len(shape)).expand(
                (5,) + shape).clone(),
        )

    def update(self, x: torch.Tensor) -> "RunningQuantile":
        c = self.count
        if c < 5:
            h = self.heights.clone()
            h[c] = x
            if c == 4:  # sort the initial block on the 5th observation
                h = torch.sort(h, dim=0).values
            return dataclasses.replace(self, count=c + 1, heights=h)

        p = self.p
        q = self.heights.clone()
        n = self.positions.clone()
        q[0] = torch.where(x < q[0], x, q[0])
        q[4] = torch.where(x >= q[4], x, q[4])
        k = (x >= q[1]).to(torch.int64) + (x >= q[2]).to(torch.int64) \
            + (x >= q[3]).to(torch.int64)  # cell index in {0,1,2,3}
        idx = torch.arange(5, device=x.device).reshape(
            (5,) + (1,) * (q.ndim - 1))
        n = n + (idx > k).to(n.dtype)
        cnt = float(c + 1)
        dn = (1.0, 1.0 + 2 * p, 1.0 + 4 * p, 3.0 + 2 * p, 5.0)
        nprime = [1 + (d - 1) / 4.0 * (cnt - 1) for d in dn]
        for i in (1, 2, 3):
            d = nprime[i] - n[i]
            move_up = (d >= 1) & (n[i + 1] - n[i] > 1)
            move_dn = (d <= -1) & (n[i - 1] - n[i] < -1)
            s = torch.where(move_up, 1.0, torch.where(move_dn, -1.0, 0.0)).to(
                q.dtype)
            do_move = s != 0
            nm, ni, np_ = n[i - 1], n[i], n[i + 1]
            qm, qi, qp = q[i - 1], q[i], q[i + 1]
            para = qi + s / (np_ - nm) * (
                (ni - nm + s) * (qp - qi) / (np_ - ni)
                + (np_ - ni - s) * (qi - qm) / (ni - nm)
            )
            ok = (qm < para) & (para < qp)
            lin = qi + s * torch.where(
                s > 0, (qp - qi) / (np_ - ni), (qi - qm) / (ni - nm))
            q[i] = torch.where(do_move, torch.where(ok, para, lin), qi)
            n[i] = torch.where(do_move, ni + s, ni)
        return dataclasses.replace(self, count=c + 1, heights=q, positions=n)

    @property
    def value(self) -> torch.Tensor:
        """Current quantile estimate (marker 2); valid once count >= 5."""
        return self.heights[2]
