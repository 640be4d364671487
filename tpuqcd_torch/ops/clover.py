"""Clover term: field strength, chiral blocks, their twisted inverse and
their apply on packed spinors.

Counterpart of ``tpuqcd/ops/clover.py``, with its conventions:

    F_mu_nu(x) = (Q_mu_nu - Q_mu_nu^dag) / (8 i),  Q the sum of the four
                 plaquette leaves around x (Hermitian)
    A(x)       = 1 + csw kappa sum_{mu<nu} sigma_mu_nu F_mu_nu(x)

A is Hermitian and block-diagonal in chirality (sigma commutes with the
diagonal gamma5), so it is stored as two 6x6 blocks per site:
[2(par), 2(chir), 6, 6, T, Z, S] complex, row/column index
3 * (spin within CHIR_SPINS[chir]) + colour.  Packed (utils/packed.pack_clover)
a parity's blocks are [2(ri), 2(chir), 6, 6, T, Z, S], the operand of
the Dslash kernel's clover epilogues.

The blocks are built in complex64 from the float32 gauge, as tpuqcd
builds them.  Their twisted inverse (A + 2 i kappa mu f gamma5)^{-1} is
computed in complex128 (tpuqcd inverts in complex64, which leaves the
even-odd system it certifies about 1e-8 away from M; ROADMAP Queue 3).
The field strength runs on the site-major gauge of ops/gauge_tools with
the broadcast 3x3 products of ops/mat3.
"""
from __future__ import annotations

import torch

from ..gammas import G5_DIAG, SIGMA_MUNU
from ..lattice import Lattice
from . import mat3
from .gauge_tools import gauge_sites, link_at, neighbour_tables

#: chirality spin groups from the diagonal gamma5
CHIR_SPINS = (tuple(s for s, g in enumerate(G5_DIAG) if g > 0),
              tuple(s for s, g in enumerate(G5_DIAG) if g < 0))
#: gamma5 eigenvalue per chirality block
CHIR_SIGN = (+1.0, -1.0)

# a chirality block is a contiguous pair of spins, so a packed spinor's
# [4, 3] axes reshape to [2(chir), 6]; the kernel assumes the same
if CHIR_SPINS != ((0, 1), (2, 3)):
    raise ImportError(f"the clover layout assumes g5 = diag(1, 1, -1, -1), got {G5_DIAG}")

#: the planes mu < nu of the clover sum
PLANES = tuple((mu, nu) for mu in range(4) for nu in range(mu + 1, 4))


def _sigma_blocks() -> torch.Tensor:
    """sigma_mu_nu of each plane restricted to the chiral blocks:
    [6(plane), 2(chir), 2, 2] complex128; the off-diagonal blocks vanish."""
    sig = torch.stack([SIGMA_MUNU[mu, nu] for mu, nu in PLANES])
    if sig[:, :2, 2:].abs().max() > 0 or sig[:, 2:, :2].abs().max() > 0:
        raise ImportError("sigma_mu_nu is not block-diagonal in chirality")
    return torch.stack([sig[:, :2, :2], sig[:, 2:, 2:]], dim=1)


_SIGMA_CHIR = _sigma_blocks()


def field_strength(u_sm: torch.Tensor, mu: int, nu: int, p: int, tables) -> torch.Tensor:
    """Hermitian clover-leaf F_mu_nu at the parity-p sites, [T*Z*S, 3, 3].

    u_sm: site-major gauge [4, 2, T*Z*S, 3, 3] (ops/gauge_tools.gauge_sites);
    tables: ops/gauge_tools.neighbour_tables of the lattice."""
    def at(m, shifts):
        return link_at(u_sm, m, p, shifts, tables)

    # leaf 1: U_mu(x) U_nu(x+mu) U_mu(x+nu)^dag U_nu(x)^dag
    q = mat3.mul(mat3.mul(mat3.mul(u_sm[mu, p], at(nu, [(mu, +1)])), at(mu, [(nu, +1)]),
                          bdag=True), u_sm[nu, p], bdag=True)
    # leaf 2: U_nu(x) U_mu(x+nu-mu)^dag U_nu(x-mu)^dag U_mu(x-mu)
    q = q + mat3.mul(mat3.mul(mat3.mul(u_sm[nu, p], at(mu, [(nu, +1), (mu, -1)]), bdag=True),
                              at(nu, [(mu, -1)]), bdag=True), at(mu, [(mu, -1)]))
    # leaf 3: U_mu(x-mu)^dag U_nu(x-mu-nu)^dag U_mu(x-mu-nu) U_nu(x-nu)
    q = q + mat3.mul(mat3.mul(mat3.mul(at(mu, [(mu, -1)]), at(nu, [(mu, -1), (nu, -1)]),
                                       adag=True, bdag=True),
                              at(mu, [(mu, -1), (nu, -1)])), at(nu, [(nu, -1)]))
    # leaf 4: U_nu(x-nu)^dag U_mu(x-nu) U_nu(x-nu+mu) U_mu(x)^dag
    q = q + mat3.mul(mat3.mul(mat3.mul(at(nu, [(nu, -1)]), at(mu, [(nu, -1)]), adag=True),
                              at(nu, [(nu, -1), (mu, +1)])), u_sm[mu, p], bdag=True)
    return (q - q.mH) / 8j


def clover_blocks(u_dev: torch.Tensor, lat: Lattice, kappa: float, csw: float) -> torch.Tensor:
    """A(x) as chiral blocks [2(par), 2(chir), 6, 6, T, Z, S], in the dtype
    of the complex device-layout gauge u_dev [4, 2, 3, 3, T, Z, S]
    (complex64 from a float32 gauge, as tpuqcd builds it)."""
    u_sm = gauge_sites(u_dev)
    tables = neighbour_tables(lat, u_dev.device)
    sig = _SIGMA_CHIR.to(device=u_dev.device, dtype=u_dev.dtype)
    n = u_sm.shape[2]
    eye = torch.eye(6, dtype=u_dev.dtype, device=u_dev.device)
    out = []
    for p in (0, 1):
        f = torch.stack([field_strength(u_sm, mu, nu, p, tables) for mu, nu in PLANES])
        # sum over planes of sigma (spin a, b) x F (colour i, j) -> rows a*3+i, cols b*3+j
        a = torch.einsum("pcab,pnij->cnaibj", sig, f).reshape(2, n, 6, 6)
        a = (csw * kappa) * a + eye
        out.append(a.permute(0, 2, 3, 1).reshape(2, 6, 6, *lat.site_shape))
    return torch.stack(out)


def clover_twist_inverse(a_blocks: torch.Tensor, kappa: float, mu: float, flavor: int,
                         parity: int) -> torch.Tensor:
    """(A + 2 i kappa mu flavor gamma5)^{-1} on one parity, in complex128:
    [2(chir), 6, 6, T, Z, S].  One batched inverse on the tensor's
    device; one-time setup per gauge, kappa, mu and flavor."""
    t = 2.0 * kappa * mu * flavor
    blk = a_blocks[parity].to(torch.complex128)
    site_shape = blk.shape[3:]
    m = blk.reshape(2, 6, 6, -1).permute(0, 3, 1, 2)                     # [2, N, 6, 6]
    sign = torch.tensor(CHIR_SIGN, dtype=torch.complex128, device=blk.device)
    m = m + (1j * t) * sign[:, None, None, None] * torch.eye(6, dtype=torch.complex128,
                                                             device=blk.device)
    return torch.linalg.inv(m).permute(0, 2, 3, 1).reshape(2, 6, 6, *site_shape)


def clover_mv(cl: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Complex chiral blocks cl [2(chir), 6, 6, *sites] times complex
    spinors x [..., 4, 3, *sites] -> [..., 4, 3, *sites] (any leading
    batch dims)."""
    sites = cl.shape[3:]
    lead = x.shape[:x.ndim - 2 - len(sites)]
    xs = x.reshape(*lead, 2, 1, 6, *sites)
    return (cl * xs).sum(len(lead) + 2).reshape(x.shape)


def clover_apply_pk(cl_pk: torch.Tensor, psi_pk: torch.Tensor) -> torch.Tensor:
    """Packed chiral blocks [2(ri), 2(chir), 6, 6, T, Z, S] applied to a
    packed spinor [2(ri), 4, 3, T, Z, S] (or a batch [N, 2(ri), ...]): a
    6x6 complex mat-vec per chirality.  Computes in float64 when either operand is float64 (float32
    entries promote exactly), else float32; returns the promoted dtype."""
    out_dt = torch.promote_types(cl_pk.dtype, psi_pk.dtype)
    rdt = torch.float64 if out_dt == torch.float64 else torch.float32
    cl = torch.complex(cl_pk[0].to(rdt), cl_pk[1].to(rdt))
    nb = psi_pk.ndim - 6
    x = torch.complex(psi_pk.select(nb, 0).to(rdt), psi_pk.select(nb, 1).to(rdt))
    y = clover_mv(cl, x)
    return torch.stack([y.real, y.imag], dim=nb).to(out_dt)
