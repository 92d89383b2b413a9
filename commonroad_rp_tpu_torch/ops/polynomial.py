"""Batched polynomial trajectory math (torch).

Counterpart of ``commonroad_rp_tpu/ops/polynomial.py``: closed-form quintic
and quartic boundary-value coefficients (reference:
commonroad_rp/polynomial_trajectory.py:282-360) and their derivatives,
evaluated for the whole candidate batch at once.

Convention: a polynomial is its coefficient vector c[..., 6] with
p(tau) = c0 + c1 tau + c2 tau^2 + ... + c5 tau^5 (quartics have c5 = 0).
Term order and the power construction follow the JAX package exactly, so the
two agree to the last bit wherever the elementwise arithmetic does.
"""

from __future__ import annotations

import torch


def quintic_coeffs(x_0: torch.Tensor, x_d: torch.Tensor,
                   delta_tau: torch.Tensor) -> torch.Tensor:
    """Quintic coefficients for (pos, vel, acc) -> (pos, vel, acc).
    Shapes: x_0 [..., 3], x_d [..., 3], delta_tau [...]; returns [..., 6]."""
    p0, v0, a0 = x_0[..., 0], x_0[..., 1], x_0[..., 2]
    p1, v1, a1 = x_d[..., 0], x_d[..., 1], x_d[..., 2]
    T = delta_tau
    T2 = T * T
    T3 = T2 * T
    T4 = T2 * T2
    T5 = T4 * T

    dp = p1 - (p0 + v0 * T + 0.5 * a0 * T2)
    dv = (v1 - (v0 + a0 * T)) * T
    da = (a1 - a0) * T2

    c3 = (10.0 * dp - 4.0 * dv + 0.5 * da) / T3
    c4 = (-15.0 * dp + 7.0 * dv - da) / T4
    c5 = (6.0 * dp - 3.0 * dv + 0.5 * da) / T5
    shape = c3.shape
    return torch.stack([p0.expand(shape), v0.expand(shape),
                        (0.5 * a0).expand(shape), c3, c4, c5], dim=-1)


def quartic_coeffs(x_0: torch.Tensor, v_d: torch.Tensor,
                   delta_tau: torch.Tensor, a_d=0.0) -> torch.Tensor:
    """Quartic coefficients: (pos, vel, acc) initial -> (vel, acc) terminal.
    Shapes: x_0 [..., 3], v_d [...], delta_tau [...]; returns [..., 6]."""
    p0, v0, a0 = x_0[..., 0], x_0[..., 1], x_0[..., 2]
    T = delta_tau
    T2 = T * T
    T3 = T2 * T

    dv = v_d - v0 - a0 * T
    da = a_d - a0

    c3 = dv / T2 - da / (3.0 * T)
    c4 = da / (4.0 * T2) - dv / (2.0 * T3)
    shape = c3.shape
    return torch.stack([p0.expand(shape), v0.expand(shape),
                        (0.5 * a0).expand(shape), c3, c4,
                        torch.zeros_like(c3)], dim=-1)


def tau_powers(tau: torch.Tensor):
    """(tau, tau^2, ..., tau^5): t2 = t^2, t3 = t2*t, t4 = t2^2, t5 = t4*t."""
    t2 = tau * tau
    t3 = t2 * tau
    t4 = t2 * t2
    t5 = t4 * tau
    return tau, t2, t3, t4, t5


def eval_position(c: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """p(tau); c [..., 6] broadcast against tau [...]."""
    t, t2, t3, t4, t5 = tau_powers(tau)
    return (c[..., 0] + c[..., 1] * t + c[..., 2] * t2 + c[..., 3] * t3 +
            c[..., 4] * t4 + c[..., 5] * t5)


def eval_velocity(c: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """p'(tau)."""
    t, t2, t3, t4, _ = tau_powers(tau)
    return (c[..., 1] + 2.0 * c[..., 2] * t + 3.0 * c[..., 3] * t2 +
            4.0 * c[..., 4] * t3 + 5.0 * c[..., 5] * t4)


def eval_acceleration(c: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """p''(tau)."""
    t, t2, t3, _, _ = tau_powers(tau)
    return (2.0 * c[..., 2] + 6.0 * c[..., 3] * t + 12.0 * c[..., 4] * t2 +
            20.0 * c[..., 5] * t3)

def eval_jerk(c: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """p'''(tau) (polynomial_trajectory.py:229-238)."""
    t, t2, _, _, _ = tau_powers(tau)
    return 6.0 * c[..., 3] + 24.0 * c[..., 4] * t + 60.0 * c[..., 5] * t2


def squared_jerk_integral(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Integral of the squared jerk over [0, t]
    (polynomial_trajectory.py:171-190)."""
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    t5 = t4 * t
    c3, c4, c5 = c[..., 3], c[..., 4], c[..., 5]
    return (36.0 * c3 * c3 * t + 144.0 * c3 * c4 * t2 + 240.0 * c3 * c5 * t3 +
            192.0 * c4 * c4 * t3 + 720.0 * c4 * c5 * t4 + 720.0 * c5 * c5 * t5)


def evaluate_state_at_tau(c: torch.Tensor, tau: torch.Tensor, tau_0,
                          delta_tau) -> torch.Tensor:
    """[p, p', p''] at tau, with the reference's clamping quirk
    (polynomial_trajectory.py:192-227: tau is clamped to [tau_0, delta_tau]
    when tau - tau_0 falls outside [0, delta_tau])."""
    tau_0 = torch.as_tensor(tau_0, dtype=tau.dtype, device=tau.device)
    delta_tau = torch.as_tensor(delta_tau, dtype=tau.dtype, device=tau.device)
    tau_prime = tau - tau_0
    tau_c = torch.where(tau_prime < 0, tau_0,
                        torch.where(tau_prime > delta_tau, delta_tau, tau))
    return torch.stack([eval_position(c, tau_c), eval_velocity(c, tau_c),
                        eval_acceleration(c, tau_c)], dim=-1)
