"""Shared Levenberg-Marquardt machinery for fixed-iteration device solves.

The port of the JAX package's optim/lm.py: g2o's damping schedule
(lambda0 = tau * max diag H with tau = 1e-5, the gain-ratio polynomial
update, nu doubling on rejection) over a fixed trip count, where a rejected
step consumes an iteration.  Everything broadcasts over leading batch
dimensions and nothing reads a value back to the host: loops are Python
loops with `torch.where` masks, and the solves use `torch.linalg.*_ex`,
whose error flags do not synchronize.
"""

from __future__ import annotations

import torch

TAU = 1e-5


def huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """g2o RobustKernelHuber IRLS weight as a function of chi2."""
    s = torch.sqrt(chi2.clamp_min(1e-20))
    return torch.where(s <= delta, 1.0, delta / s)


def huber_rho(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """g2o robustified cost: s if sqrt(s) <= delta else 2 delta sqrt(s) -
    delta^2."""
    s = torch.sqrt(chi2.clamp_min(1e-20))
    return torch.where(s <= delta, chi2, 2.0 * delta * s - delta * delta)


def lm_init_lambda(H: torch.Tensor) -> torch.Tensor:
    """g2o: lambda0 = tau * max diag of the undamped Hessian."""
    return TAU * torch.diagonal(H, dim1=-2, dim2=-1).amax(-1)


def lm_update(accepted, rho, lam, nu):
    """One g2o-style damping update; rho = gain ratio."""
    scale = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    lam_new = torch.where(accepted, lam * scale, lam * nu)
    nu_new = torch.where(accepted, torch.full_like(nu, 2.0), nu * 2.0)
    return lam_new, nu_new


def solve_damped(H: torch.Tensor, b: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """Solve (H + lam I) dx = b, Jacobi-preconditioned to unit diagonal;
    a non-finite solution (an exactly singular H) becomes a zero step."""
    n = H.shape[-1]
    Hd = H + lam[..., None, None] * torch.eye(n, dtype=H.dtype,
                                              device=H.device)
    d = 1.0 / torch.sqrt(torch.diagonal(Hd, dim1=-2, dim2=-1)
                         .clamp_min(1e-30))
    Hs = Hd * d[..., :, None] * d[..., None, :]
    ys, _ = torch.linalg.solve_ex(Hs, (b * d)[..., None])
    dx = ys[..., 0] * d
    return torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, 0.0)


def gain_ratio(chi2_old, chi2_new, dx, b, lam):
    """g2o: rho = (F(x) - F(x + dx)) / (dx^T (lambda dx + b))."""
    denom = (dx * (lam[..., None] * dx + b)).sum(-1)
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    return (chi2_old - chi2_new) / denom
