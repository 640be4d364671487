"""Hadron two-point contractions on packed device propagators.

Counterpart of ``tpuqcd/phys/contract_dev.py``.  tpuqcd unrolls the Wick
sums into thousands of real plane products because its TPU backend has
no complex contraction; here they are complex ``torch.einsum``s over the
same packed planes, in the same factored diquark form:

  W[r,c,v,f]   = sum_{s,u} G[r,s] Sd[s,c,u,f] Gt[u,v]     (G = C g5)
  ta: A1[a,d]  = sum eps_abc eps_def Su[r,b,v,e] W[r,c,v,f]
      ta       = sum proj[n,m] Su[m,a,n,d] A1[a,d]
  tb: B[a,e,n,v] = sum eps_abc eps_def Su[r,b,n,d] W[r,c,v,f]
      tb       = sum proj[n,m] Su[m,a,v,e] B[a,e,n,v]
  C2 density   = ta - tb

Propagator device layout:
    ``[2(ri), 2(par), 4(snk s), 3(snk c), 4(src s), 3(src c), T, Z, S]``
S = Y * X//2.  The sites are contracted in chunks (``SITE_CHUNK``), so the
largest intermediate, B's 1296 complex numbers a site, stays bounded
whatever the volume.  Against tpuqcd's unrolled engine on the same
float32 propagators the densities agree to 1e-5 of their maximum
(tests/test_torch_contract.py): the two sum in different orders.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields import eo_to_full, full_to_eo
from ..gammas import CGAMMA5, EPS3, G5_DIAG, PARITY_PLUS, gbar
from ..lattice import Lattice
from .threep_dev import project_momenta_pk

#: sites contracted at once (B is 1296 x 8 bytes a site in complex64)
SITE_CHUNK = 1 << 16


def prop_to_device(prop_full: torch.Tensor, lat: Lattice,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """complex [T, Z, Y, X, 4, 3, 4, 3] -> the packed device layout."""
    eo = full_to_eo(prop_full, lat)                      # [2, T, Z, Y, Xh, 4, 3, 4, 3]
    dev = torch.movedim(eo, (5, 6, 7, 8), (1, 2, 3, 4))
    dev = dev.reshape(2, 4, 3, 4, 3, *lat.site_shape)
    return torch.stack([dev.real, dev.imag]).to(dtype)


def density_to_full(dens_pk: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """packed density [2(ri), 2(par), T, Z, S] -> complex [T, Z, Y, X]."""
    c = torch.complex(dens_pk[0], dens_pk[1])
    return eo_to_full(c.reshape(2, lat.Lt, lat.Lz, lat.Ly, lat.Lx // 2), lat)


def _sites(prop_pk: torch.Tensor) -> torch.Tensor:
    """Packed propagator -> complex [4, 3, 4, 3, n] over all sites of both
    parities (parity major), complex128 for float64 planes."""
    rdt = torch.float64 if prop_pk.dtype == torch.float64 else torch.float32
    c = torch.complex(prop_pk[0].to(rdt), prop_pk[1].to(rdt))   # [2par, 4, 3, 4, 3, T, Z, S]
    return c.movedim(0, 4).flatten(4)


def _density(fn, props, shape) -> torch.Tensor:
    """fn on chunks of sites of complex propagators [4, 3, 4, 3, n] ->
    the packed density [2(ri), 2(par), T, Z, S]."""
    n = props[0].shape[-1]
    out = torch.cat([fn(*(p[..., i:i + SITE_CHUNK] for p in props))
                     for i in range(0, n, SITE_CHUNK)])
    return torch.stack([out.real, out.imag]).reshape(2, 2, *shape)


def proton_2pt_site_dev(su: torch.Tensor, sd: torch.Tensor,
                        proj: torch.Tensor = PARITY_PLUS) -> torch.Tensor:
    """Projected proton correlator density, packed [2(ri), 2(par), T, Z, S]:
    the Wick-contracted uud with G = C g5 diquark vertices and the given
    parity projector (the factored form of the module docstring)."""
    cu, cd = _sites(su), _sites(sd)
    cdt, dev = cu.dtype, cu.device
    g, gt = CGAMMA5.to(dev, cdt), gbar(CGAMMA5).to(dev, cdt)
    eps, pr = EPS3.to(dev, cdt), torch.as_tensor(proj).to(dev, cdt)

    def chunk(u, d):
        w = torch.einsum("rs,scufx,uv->rcvfx", g, d, gt)
        a1 = torch.einsum("abc,def,becfx->adx", eps, eps,
                          torch.einsum("rbvex,rcvfx->becfx", u, w))
        ta = torch.einsum("nm,mandx,adx->x", pr, u, a1)
        b = torch.einsum("abc,def,bdcfnvx->aenvx", eps, eps,
                         torch.einsum("rbndx,rcvfx->bdcfnvx", u, w))
        return ta - torch.einsum("nm,mavex,aenvx->x", pr, u, b)

    return _density(chunk, (cu, cd), su.shape[-3:])


def meson_2pt_site_dev(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """- Tr[Gamma S2 Gammabar g5 S1^dag g5] density, packed layout."""
    c1, c2 = _sites(s1), _sites(s2)
    cdt, dev = c1.dtype, c1.device
    gm = torch.as_tensor(gamma).to(dev, cdt)
    gb = gbar(torch.as_tensor(gamma).to(torch.complex128)).to(dev, cdt)
    g5 = torch.tensor(G5_DIAG, dtype=c1.real.dtype, device=dev)

    def chunk(a, b):
        # [g5 S1^dag g5]_{(n d),(m a)} = g5[n] conj(S1_{(m a),(n d)}) g5[m]
        left = torch.einsum("mr,ravdx->mavdx", gm, b)
        right = torch.einsum("vn,mandx->mavdx", gb * g5[None, :],
                             a.conj() * g5[:, None, None, None, None])
        return -(left * right).sum((0, 1, 2, 3))

    return _density(chunk, (c1, c2), s1.shape[-3:])


def _src_xyz(src_pos):
    return (src_pos[3], src_pos[2], src_pos[1])


def proton_2pt_dev(su: torch.Tensor, sd: torch.Tensor, lat: Lattice, momenta: np.ndarray,
                   src_pos=(0, 0, 0, 0), proj: torch.Tensor = PARITY_PLUS) -> torch.Tensor:
    """complex [n_mom, T] projected proton two-point function, on the
    propagators' device; src_pos = (t0, z0, y0, x0)."""
    return project_momenta_pk(proton_2pt_site_dev(su, sd, proj), lat, momenta,
                              _src_xyz(src_pos))


def neutron_2pt_dev(su: torch.Tensor, sd: torch.Tensor, lat: Lattice, momenta: np.ndarray,
                    src_pos=(0, 0, 0, 0), proj: torch.Tensor = PARITY_PLUS) -> torch.Tensor:
    """Neutron two-point function: the isospin mirror of the proton (the u
    and d propagators swapped)."""
    return proton_2pt_dev(sd, su, lat, momenta, src_pos=src_pos, proj=proj)


def meson_2pt_dev(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor, lat: Lattice,
                  momenta: np.ndarray, src_pos=(0, 0, 0, 0)) -> torch.Tensor:
    """complex [n_mom, T] meson two-point function."""
    return project_momenta_pk(meson_2pt_site_dev(s1, s2, gamma), lat, momenta,
                              _src_xyz(src_pos))
