"""Gaussian (Wuppertal) source and sink smearing on APE-smeared links.

Counterpart of ``tpuqcd/phys/smear.py:85-116`` (the packed form, which is
the one the two-point run takes):

    psi -> [ (1 + alpha H) / (1 + 6 alpha) ]^n psi,
    H psi(x) = sum_{i in x,y,z} [ U_i(x) psi(x+i) + U_i(x-i)^dag psi(x-i) ]

on packed two-parity fields [..., 2(par), 2(ri), 4, 3, T, Z, S] with any
leading batch dims (the 12 columns of a propagator smear as one batch,
where tpuqcd vmaps), u_pk the packed 18-real gauge of ops/gauge_tools.
ape_smear.  Smearing is spatial, so it never mixes timeslices.  Inside,
the fields are complex and a neighbour is a gather through the Dslash's
own index tables (the shifts of tpuqcd/ops/shifts.py:17).

On a LatticeMesh the field is a rank's block (or a run of its
timeslices) and the links its block with a ghost layer in z and y
(parallel/sharded.ghost_block): each step exchanges the iterate's z and
y faces (sharded.exchange_ghosts) and gathers through ghost_tables.
"""
from __future__ import annotations

import torch

from ..lattice import Lattice
from ..ops.gauge_tools import neighbour_tables
from ..utils.packed import unpack_gauge

#: the mesh axes a spatial hop reads across (t and x never)
SMEAR_AXES = ("z", "y")


def _to_complex(psi_pk: torch.Tensor) -> torch.Tensor:
    """[..., 2(par), 2(ri), 4, 3, T, Z, S] -> complex [..., 2(par), 4, 3, T*Z*S]."""
    ri = psi_pk.ndim - 6
    rdt = torch.float64 if psi_pk.dtype == torch.float64 else torch.float32
    return torch.complex(psi_pk.select(ri, 0).to(rdt),
                         psi_pk.select(ri, 1).to(rdt)).flatten(-3)


def _to_packed(psi_c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    ri = like.ndim - 6
    return torch.stack([psi_c.real, psi_c.imag], dim=ri).reshape(like.shape).to(like.dtype)


def _cov_laplace_3d(links: torch.Tensor, links_x: torch.Tensor, psi_x: torch.Tensor,
                    tables) -> torch.Tensor:
    """H psi on complex fields: links [4, 2, 3, 3, n] at the n output sites;
    links_x [4, 2, 3, 3, m] and psi_x [..., 2(par), 4, 3, m] on the m sites
    the tables gather from (the same field on a whole lattice, the block
    with its ghost layer on a mesh)."""
    out = []
    for p in (0, 1):
        src = psi_x[..., 1 - p, :, :, :]
        idx = tables[1 - p]
        acc = None
        for i in range(3):                        # spatial directions
            fwd = torch.einsum("ijn,...sjn->...sin", links[i, p], src[..., idx[i, 0]])
            g = torch.einsum("jin,...sjn->...sin", links_x[i, 1 - p].conj(), src)
            t = fwd + g[..., idx[i, 1]]
            acc = t if acc is None else acc + t
        out.append(acc)
    return torch.stack(out, dim=-4)


def _hood(u_pk: torch.Tensor, psi_pk: torch.Tensor, lat: Lattice, lmesh):
    """(links at the output sites, links on the gathered sites, a function
    giving the iterate on the gathered sites, the tables), complex
    [4, 2, 3, 3, n]."""
    links_x = unpack_gauge(u_pk).to(
        torch.complex128 if psi_pk.dtype == torch.float64 else torch.complex64)
    if lmesh is None:
        links_x = links_x.flatten(-3)
        return links_x, links_x, lambda v: v, neighbour_tables(lat, psi_pk.device)
    from ..parallel.sharded import exchange_ghosts, ghost_tables
    site_shape, xh = psi_pk.shape[-3:], lat.Lx // 2
    links = links_x[..., 1:-1, xh:-xh].flatten(-3)

    def ghosted(v):
        ext = exchange_ghosts(lmesh, v.unflatten(-1, tuple(site_shape)), SMEAR_AXES)
        return ext.flatten(-3)
    return (links, links_x.flatten(-3), ghosted,
            ghost_tables(site_shape, lat.Lx, SMEAR_AXES, psi_pk.device))


def cov_laplace_3d_pk(u_pk: torch.Tensor, psi_pk: torch.Tensor, lat: Lattice,
                      lmesh=None) -> torch.Tensor:
    """H psi on packed fields: u_pk [4, 2, 3, 3, 2(ri), T, Z, S], psi_pk
    [..., 2(par), 2(ri), 4, 3, T, Z, S]; on a mesh (``lmesh``) psi_pk is
    this rank's block and u_pk its links with the ghost layer in z and y
    (parallel/sharded.ghost_block(lmesh, u, SMEAR_AXES))."""
    links, links_x, ghosted, tables = _hood(u_pk, psi_pk, lat, lmesh)
    out = _cov_laplace_3d(links, links_x, ghosted(_to_complex(psi_pk)), tables)
    return _to_packed(out, psi_pk)


def gaussian_smear_pk(u_pk: torch.Tensor, psi_pk: torch.Tensor, lat: Lattice,
                      alpha: float = 4.0, n_steps: int = 50, lmesh=None) -> torch.Tensor:
    """n_steps Wuppertal iterations on packed fields (see the module
    docstring); the iterate is rounded to psi_pk's dtype after every step,
    as in tpuqcd.  On a mesh (``lmesh``) psi_pk is this rank's block, or a
    run of its timeslices, and u_pk its links on the same timeslices with
    the ghost layer in z and y; every rank of the block's z and y rings
    smears (each step exchanges faces with them)."""
    if n_steps <= 0:
        return psi_pk
    norm = 1.0 / (1.0 + 6.0 * alpha)
    links, links_x, ghosted, tables = _hood(u_pk, psi_pk, lat, lmesh)
    v = _to_complex(psi_pk)
    for _ in range(n_steps):
        v = norm * (v + alpha * _cov_laplace_3d(links, links_x, ghosted(v), tables))
        if psi_pk.dtype == torch.bfloat16:
            v = torch.complex(v.real.bfloat16().float(), v.imag.bfloat16().float())
    return _to_packed(v, psi_pk)
