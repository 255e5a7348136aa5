"""Log-domain Sinkhorn divergence with epsilon-scaling
(``deltakd_tpu/kd/sinkhorn.py``), batched over a leading axis.

WassKD's 'sinkhorn' mode compares token point clouds by the debiased
entropic-OT divergence S_e(a, b) = OT_e(a, b) - OT_e(a, a) / 2 - OT_e(b, b) / 2
with uniform weights, the ground cost C(x, y) = |x - y|^2 / 2 and the
temperature e = blur^2 (geomloss's p=2 conventions). Two stages:

1. **Potential solve**, not differentiated: log-domain Sinkhorn with the
   temperature annealed geometrically from the cost diameter down to e over
   ``n_iters`` levels, then ``n_final`` refinements at e. A Python loop over
   the levels, each level one ``logsumexp`` over the whole batch.
2. **Differentiable finalize**: one more Sinkhorn half-iteration through a
   freshly built cost matrix with the solved potentials held fixed, the
   envelope gradient that geomloss uses as well.

Everything is fp32. The cost is ``x^2 + y^2 - 2xy``; at e = 0.0025 a
TF32 product (10 mantissa bits) would swamp it, so ``_cost`` forms the
cross product in fp64 and rounds it to fp32, out of reach of the process's
TF32 setting, forward and backward.
"""

from __future__ import annotations

import math

import torch

DEFAULT_N_ITERS = 20
DEFAULT_N_FINAL = 6


def _cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Half squared Euclidean cost matrices [B, N, M] of x [B, N, D] and
    y [B, M, D] (fp32)."""
    x2 = torch.sum(x * x, dim=-1)[:, :, None]
    y2 = torch.sum(y * y, dim=-1)[:, None, :]
    xy = torch.bmm(x.double(), y.double().transpose(1, 2)).float()
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0) / 2.0


def _eps_schedule(diameter: torch.Tensor, eps: float, n_levels: int,
                  n_final: int) -> torch.Tensor:
    """Per problem: a geometric anneal from the diameter [B] to eps over
    n_levels, then n_final levels at eps -> [B, n_levels + n_final]."""
    d = torch.clamp_min(diameter, eps)[:, None]
    ts = torch.linspace(0.0, 1.0, n_levels, device=d.device)
    log_eps = torch.log(torch.full_like(d, eps))
    anneal = torch.exp(torch.log(d) + ts * (log_eps - torch.log(d)))
    return torch.cat([anneal, torch.full((d.shape[0], n_final), eps, device=d.device)], 1)


@torch.no_grad()
def _solve_scan(x: torch.Tensor, y: torch.Tensor, eps: float, n_iters: int,
                n_final: int):
    """Fixed-point potentials (f_xy [B, N], g_xy [B, M], f_xx [B, N],
    f_yy [B, M]) of the problems x [B, N, D], y [B, M, D]."""
    x, y = x.detach(), y.detach()
    c_xy, c_xx, c_yy = _cost(x, y), _cost(x, x), _cost(y, y)
    B, n, m = c_xy.shape
    log_a, log_b = -math.log(n), -math.log(m)
    sched = _eps_schedule(torch.amax(c_xy, dim=(1, 2)), eps, n_iters, n_final)

    f, g = x.new_zeros(B, n), x.new_zeros(B, m)
    for k in range(sched.shape[1]):
        e = sched[:, k, None, None]
        g = -e[:, 0] * torch.logsumexp((f[:, :, None] - c_xy) / e + log_a, 1)
        f = -e[:, 0] * torch.logsumexp((g[:, None, :] - c_xy) / e + log_b, 2)

    fx, fy = x.new_zeros(B, n), x.new_zeros(B, m)
    for k in range(sched.shape[1]):
        e = sched[:, k, None, None]
        fxt = -e[:, 0] * torch.logsumexp((fx[:, None, :] - c_xx) / e + log_a, 2)
        fyt = -e[:, 0] * torch.logsumexp((fy[:, None, :] - c_yy) / e + log_b, 2)
        fx, fy = 0.5 * (fx + fxt), 0.5 * (fy + fyt)
    return f, g, fx, fy


def _finalize(x: torch.Tensor, y: torch.Tensor, pots, eps: float) -> torch.Tensor:
    """Debiased divergences [B] from fixed potentials, differentiable in x, y."""
    f_xy, g_xy, f_xx, f_yy = (p.detach() for p in pots)
    n, m = x.shape[1], y.shape[1]
    log_a, log_b = -math.log(n), -math.log(m)
    c_xy = _cost(x, y)
    g_fin = -eps * torch.logsumexp((f_xy[:, :, None] - c_xy) / eps + log_a, 1)
    f_fin = -eps * torch.logsumexp((g_xy[:, None, :] - c_xy) / eps + log_b, 2)
    ot_xy = f_fin.mean(1) + g_fin.mean(1)
    f_xx_fin = -eps * torch.logsumexp((f_xx[:, None, :] - _cost(x, x)) / eps + log_a, 2)
    f_yy_fin = -eps * torch.logsumexp((f_yy[:, None, :] - _cost(y, y)) / eps + log_b, 2)
    return ot_xy - 0.5 * (2.0 * f_xx_fin.mean(1) + 2.0 * f_yy_fin.mean(1))


def batched_sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, *, blur: float = 0.05,
                                n_iters: int = DEFAULT_N_ITERS,
                                n_final: int = DEFAULT_N_FINAL) -> torch.Tensor:
    """Debiased Sinkhorn divergences of x [B, N, D] and y [B, M, D] -> [B]:
    one batched solve (the JAX package vmaps the one-problem solve)."""
    x, y = x.float(), y.float()
    eps = blur ** 2
    return _finalize(x, y, _solve_scan(x, y, eps, n_iters, n_final), eps)


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, *, blur: float = 0.05,
                        n_iters: int = DEFAULT_N_ITERS,
                        n_final: int = DEFAULT_N_FINAL) -> torch.Tensor:
    """Debiased Sinkhorn divergence between point clouds x [N, D] and
    y [M, D] (a 0-d tensor)."""
    return batched_sinkhorn_divergence(x[None], y[None], blur=blur, n_iters=n_iters,
                                       n_final=n_final)[0]
