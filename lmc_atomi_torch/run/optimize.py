"""MAP optimizers (counterpart of ``lmc_atomi_tpu/run/optimize.py``):
(adaptive) primal-dual hybrid gradient and FISTA, as plain torch loops with
fixed trip counts. The adaptive step sizes stay on the device as 0-d tensors
(``torch.where``), so an iteration never waits for the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

__all__ = [
    "pdhg", "adaptive_pdhg", "adaptive_pdhg_segmented", "fista",
    "fista_segmented", "OptResult",
]


class OptResult(NamedTuple):
    x: Any
    y: Any
    metrics: Optional[Dict[str, torch.Tensor]]
    state: Any = None  # the loop carry, for segmented continuation


class _Series:
    """Per-iteration metric rows, stacked into one tensor per name."""

    def __init__(self, metrics):
        self.fns = metrics or {}
        self.rows = {name: [] for name in self.fns}

    def record(self, x):
        for name, fn in self.fns.items():
            self.rows[name].append(torch.as_tensor(fn(x)))

    def result(self):
        if not self.fns:
            return None
        return {k: torch.stack(v) if v else torch.empty(0)
                for k, v in self.rows.items()}


def pdhg(proxf, proxg, a_op, x0, tau: float, mu: float, niter: int,
         theta: float = 1.0,
         metrics: Optional[Dict[str, Callable]] = None) -> OptResult:
    """Plain Chambolle-Pock PDHG for min_x f(x) + g(A x)."""
    series = _Series(metrics)
    x, y, xbar = x0, a_op.matvec(x0) * 0.0, x0
    for _ in range(niter):
        y = proxg.proxdual(y + mu * a_op.matvec(xbar), mu)
        x_new = proxf.prox(x - tau * a_op.rmatvec(y), tau)
        xbar = x_new + theta * (x_new - x)
        x = x_new
        series.record(x)
    return OptResult(x=x, y=y, metrics=series.result())


def adaptive_pdhg(proxf, proxg, a_op, x0, tau: float, mu: float, niter: int,
                  alpha0: float = 0.5, eta: float = 0.95, s: float = 1.0,
                  delta: float = 1.5,
                  metrics: Optional[Dict[str, Callable]] = None,
                  init_state: Any = None) -> OptResult:
    """Adaptive PDHG with residual balancing (Goldstein, Li, Yuan, Esser &
    Baraniuk 2015; pyproximal ``AdaptivePrimalDual``). After each iteration

        p = (x_k - x_{k+1})/tau - A^T (y_k - y_{k+1})
        d = (y_k - y_{k+1})/mu  - A  (x_k - x_{k+1})

    and when one norm exceeds ``s * delta`` times the other, the step sizes
    shift toward the lagging side (tau <- tau/(1-alpha), mu <- mu (1-alpha),
    or the reverse) and alpha decays by ``eta``. ``init_state`` (a previous
    result's ``state``: x, y, tau_k, mu_k, alpha) continues exactly.
    """
    series = _Series(metrics)
    if init_state is None:
        scalar = dict(dtype=x0.dtype, device=x0.device)
        x, y = x0, a_op.matvec(x0) * 0.0
        tau_k = torch.tensor(tau, **scalar)
        mu_k = torch.tensor(mu, **scalar)
        alpha = torch.tensor(alpha0, **scalar)
    else:
        x, y, tau_k, mu_k, alpha = init_state
    for _ in range(niter):
        # x first (the Arrow-Hurwicz ordering of Goldstein et al.)
        x_new = proxf.prox(x - tau_k * a_op.rmatvec(y), tau_k)
        xbar = 2.0 * x_new - x
        y_new = proxg.proxdual(y + mu_k * a_op.matvec(xbar), mu_k)
        dx = x - x_new
        dy = y - y_new
        pn = torch.linalg.norm(torch.ravel(dx / tau_k - a_op.rmatvec(dy)))
        dn = torch.linalg.norm(torch.ravel(dy / mu_k - a_op.matvec(dx)))
        grow = pn > s * dn * delta  # primal residual large: bigger tau
        shrink = dn > s * pn * delta  # dual residual large: smaller tau
        tau_k, mu_k, alpha = (
            torch.where(grow, tau_k / (1 - alpha),
                        torch.where(shrink, tau_k * (1 - alpha), tau_k)),
            torch.where(grow, mu_k * (1 - alpha),
                        torch.where(shrink, mu_k / (1 - alpha), mu_k)),
            torch.where(grow | shrink, alpha * eta, alpha),
        )
        x, y = x_new, y_new
        series.record(x)
    return OptResult(x=x, y=y, metrics=series.result(),
                     state=(x, y, tau_k, mu_k, alpha))


def _run_segmented(seg, x0, niter: int, segment_steps: int) -> OptResult:
    """``seg(x0, state, n) -> OptResult`` runs of ``segment_steps``
    iterations each, the whole carry crossing segments (the same iterates as
    one run); the metric rows concatenate."""
    done, state, outs, res = 0, None, [], None
    while done < niter:
        n = min(segment_steps, niter - done)
        res = seg(x0, state, n)
        state = res.state
        if res.metrics:
            outs.append(res.metrics)
        done += n
    merged = {k: torch.cat([o[k] for o in outs]) for k in outs[0]} if outs else None
    return OptResult(x=res.x, y=res.y, metrics=merged, state=res.state)


def adaptive_pdhg_segmented(proxf, proxg, a_op, x0, tau: float, mu: float,
                            niter: int, segment_steps: int = 100,
                            metrics: Optional[Dict[str, Callable]] = None,
                            **kw) -> OptResult:
    """Segmented :func:`adaptive_pdhg` (see :func:`_run_segmented`)."""
    return _run_segmented(
        lambda x, st, n: adaptive_pdhg(proxf, proxg, a_op, x, tau, mu, n,
                                       metrics=metrics, init_state=st, **kw),
        x0, niter, segment_steps)


def fista(grad_f: Callable, prox_g: Callable, x0, tau: float, niter: int,
          metrics: Optional[Dict[str, Callable]] = None,
          init_state: Any = None) -> OptResult:
    """Accelerated proximal gradient (FISTA, Beck & Teboulle 2009) for
    min_x f(x) + g(x): x_{k+1} = prox_{tau g}(z_k - tau grad f(z_k)) with
    Nesterov momentum on z. ``init_state`` (x, z, t) continues exactly."""
    series = _Series(metrics)
    if init_state is None:
        x, z, t = x0, x0, torch.tensor(1.0, dtype=x0.dtype, device=x0.device)
    else:
        x, z, t = init_state
    for _ in range(niter):
        x_new = prox_g(z - tau * grad_f(z), tau)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
        series.record(x)
    return OptResult(x=x, y=None, metrics=series.result(), state=(x, z, t))


def fista_segmented(grad_f: Callable, prox_g: Callable, x0, tau: float,
                    niter: int, segment_steps: int = 100,
                    metrics: Optional[Dict[str, Callable]] = None) -> OptResult:
    """Segmented :func:`fista` (see :func:`_run_segmented`)."""
    return _run_segmented(
        lambda x, st, n: fista(grad_f, prox_g, x, tau, n, metrics=metrics,
                               init_state=st),
        x0, niter, segment_steps)
