"""The plain float64 twisted-mass Wilson operator and the residuals that
judge a solve.

    M psi = (1 + i tw g5) psi - kappa D psi,   tw = 2 kappa mu flavor,
    D psi(x) = sum_mu (1 - g_mu) U_mu(x) psi(x + mu)
                    + (1 + g_mu) U_mu(x - mu)^dag psi(x - mu),

Euclidean hermitian gammas in the DeGrand-Rossi basis (g5 = diag(1, 1, -1,
-1)), mu = (x, y, z, t), the fermion's antiperiodic t boundary folded into
the t links at t = Lt - 1.  Fields are complex128 [T, Z, Y, X, 4, 3] and
links [4, T, Z, Y, X, 3, 3].  Colour products are broadcast multiplies and
sums (elementwise kernels), one column at a time.
"""
from __future__ import annotations

import torch

_i = 1j
GAMMA = torch.tensor([
    [[0, 0, 0, _i], [0, 0, _i, 0], [0, -_i, 0, 0], [-_i, 0, 0, 0]],
    [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
    [[0, 0, _i, 0], [0, 0, 0, -_i], [-_i, 0, 0, 0], [0, _i, 0, 0]],
    [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]],
], dtype=torch.complex128)
GAMMA5 = GAMMA[0] @ GAMMA[1] @ GAMMA[2] @ GAMMA[3]
#: the site axis of direction mu in [T, Z, Y, X]
AXIS = (3, 2, 1, 0)


def phased(u: torch.Tensor, antiperiodic_t: bool = True) -> torch.Tensor:
    """The links with the fermion t boundary folded in (a copy)."""
    out = u.clone()
    if antiperiodic_t:
        out[3, -1] = -out[3, -1]
    return out


def colour_mv(u: torch.Tensor, psi: torch.Tensor, dag: bool = False) -> torch.Tensor:
    """U psi (or U^dag psi) at every site: u [..., 3, 3], psi [..., 4, 3]."""
    if dag:
        return (u.conj()[..., None, :, :] * psi[..., :, :, None]).sum(-2)
    return (u[..., None, :, :] * psi[..., :, None, :]).sum(-1)


def spin_mv(g: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """g psi at every site: g [4, 4], psi [..., 4, 3]."""
    return (g[:, :, None] * psi[..., None, :, :]).sum(-2)


def hop(u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """D psi; u the phased links, psi [T, Z, Y, X, 4, 3]."""
    gam = GAMMA.to(psi.device)
    out = torch.zeros_like(psi)
    for mu in range(4):
        ax = AXIS[mu]
        f = colour_mv(u[mu], torch.roll(psi, -1, dims=ax))
        out += f - spin_mv(gam[mu], f)
        b = torch.roll(colour_mv(u[mu], psi, dag=True), 1, dims=ax)
        out += b + spin_mv(gam[mu], b)
    return out


def g5(psi: torch.Tensor) -> torch.Tensor:
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=torch.float64, device=psi.device)
    return psi * sign[:, None]


def apply_m(u, psi, kappa: float, mu: float, flavor: int) -> torch.Tensor:
    tw = 2.0 * kappa * mu * flavor
    return psi + 1j * tw * g5(psi) - kappa * hop(u, psi)


def apply_moo_inv(psi, kappa: float, mu: float, flavor: int) -> torch.Tensor:
    """(1 + i tw g5)^{-1} psi, the site-diagonal block's inverse."""
    tw = 2.0 * kappa * mu * flavor
    return (psi - 1j * tw * g5(psi)) / (1.0 + tw * tw)


def residuals(u, b: torch.Tensor, x: torch.Tensor, kappa: float, mu: float, flavor: int,
              even: torch.Tensor) -> dict:
    """Residual norms of M x = b (full-layout b, x; ``even`` the bool [T, Z,
    Y, X] mask of parity 0):

    full  |b - M x| / |b|, the two-parity system;
    schur |bhat - Mhat x_e| / |bhat| of the even-odd Schur complement
          Mhat = M_ee - M_eo M_oo^{-1} M_oe, bhat = b_e - M_eo M_oo^{-1} b_o,
          worked out from r = b - M x as r_e - M_eo M_oo^{-1} r_o;
    odd   |r_o| / |b|, which the Schur residual does not see."""
    r = b - apply_m(u, x, kappa, mu, flavor)
    m = even[..., None, None]
    nb = torch.linalg.vector_norm(b).item()

    def schur_part(v):
        return torch.where(m, v + kappa * hop(u, apply_moo_inv(torch.where(m, 0, v), kappa,
                                                                  mu, flavor)), 0)
    rhat, bhat = schur_part(r), schur_part(b)
    return {"full": torch.linalg.vector_norm(r).item() / nb,
            "schur": torch.linalg.vector_norm(rhat).item()
            / torch.linalg.vector_norm(bhat).item(),
            "odd": torch.linalg.vector_norm(torch.where(m, 0, r)).item() / nb}
