"""The plain reference of the two-point measurement: APE link smearing,
Gaussian (Wuppertal) smearing of sources and sinks, the proton, neutron
and meson contractions and the momentum projection, in complex128 on the
full layout.

    APE:   U_i <- Proj_SU3[(1 - a) U_i + a/4 sum_{j != i} staples_ij], i, j
           spatial, every staple from the links before the step; t links kept
    Gauss: psi <- (psi + a H psi) / (1 + 6 a),
           H psi(x) = sum_{i=x,y,z} U_i(x) psi(x+i) + U_i(x-i)^dag psi(x-i)
    proton density, G = C g5, Gb = g_t G^dag g_t, P the projector:
           W[r,c,v,f] = G[r,s] Sd[s,c,u,f] Gb[u,v]
           ta = P[n,m] Su[m,a,n,d] eps_abc eps_def Su[r,b,v,e] W[r,c,v,f]
           tb = P[n,m] Su[m,a,v,e] eps_abc eps_def Su[r,b,n,d] W[r,c,v,f]
           C = ta - tb; the neutron swaps u and d
    meson: C = - Tr[Gam S2 Gamb g5 S1^dag g5], Gamb = g_t Gam^dag g_t
    C(p, t) = sum_{x,y,z} exp(-2 pi i p.(x - x0)/L) C(t, z, y, x)

S[x][s, c, u, f] is the propagator: sink spin and colour, source spin and
colour (column u*3 + f).  The projection matrix of SU(3) is the Newton
iteration the program's smearing uses (a frozen copy, inputs/heatbath.py).
``rnd`` rounds each stage's result: the identity, or bfloat16 for the
control.
"""
from __future__ import annotations

import torch

from ..inputs.heatbath import project_su3
from .operator import AXIS, GAMMA, GAMMA5, colour_mv

CMAT = GAMMA[1] @ GAMMA[3]
CGAMMA5 = CMAT @ GAMMA5
ID4 = torch.eye(4, dtype=torch.complex128)
PROJECTORS = {"P+": 0.5 * (ID4 + GAMMA[3]), "P-": 0.5 * (ID4 - GAMMA[3])}
MESONS = {"pion": GAMMA5, "a0": ID4, "pion_g4": GAMMA[3] @ GAMMA5}
EPS = torch.zeros(3, 3, 3, dtype=torch.complex128)
for _a, _b, _c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
    EPS[_a, _b, _c], EPS[_a, _c, _b] = 1.0, -1.0
SITE_CHUNK = 1 << 15


def exact(z):
    return z


def bf16(z):
    """Re and im rounded to bfloat16."""
    return torch.complex(z.real.to(torch.bfloat16).to(z.real.dtype),
                         z.imag.to(torch.bfloat16).to(z.imag.dtype))


def _mm(a, b, adag=False):
    a = a.conj().transpose(-1, -2) if adag else a
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def ape_smear(u: torch.Tensor, alpha: float, n_steps: int, rnd=exact) -> torch.Tensor:
    """Spatial APE smearing of unphased links [4, T, Z, Y, X, 3, 3]."""
    w = alpha / 4.0
    u = rnd(u)
    for _ in range(n_steps):
        new = u.clone()
        for mu in range(3):
            st = torch.zeros_like(u[mu])
            for nu in range(3):
                if nu == mu:
                    continue
                am, an = AXIS[mu], AXIS[nu]
                fwd = _mm(_mm(u[nu], torch.roll(u[mu], -1, an)),
                          torch.roll(u[nu], -1, am).conj().transpose(-1, -2))
                a = torch.roll(u[nu], 1, an)
                b = torch.roll(u[mu], 1, an)
                c = torch.roll(torch.roll(u[nu], 1, an), -1, am)
                st += fwd + _mm(_mm(a, b, adag=True), c)
            new[mu] = rnd(project_su3((1.0 - alpha) * u[mu] + w * st))
        u = new
    return u


def gauss_smear(u: torch.Tensor, psi: torch.Tensor, alpha: float, n_steps: int,
                rnd=exact) -> torch.Tensor:
    """n_steps Wuppertal steps of psi [T, Z, Y, X, 4, 3] on links u."""
    norm = 1.0 / (1.0 + 6.0 * alpha)
    v = rnd(psi)
    for _ in range(n_steps):
        h = torch.zeros_like(v)
        for i in range(3):
            ax = AXIS[i]
            h += colour_mv(u[i], torch.roll(v, -1, ax))
            h += torch.roll(colour_mv(u[i], v, dag=True), 1, ax)
        v = rnd(norm * (v + alpha * h))
    return v


def point_source(dims, pos, column: int, device=None) -> torch.Tensor:
    """The delta source of column s*3 + c at pos = (t, z, y, x)."""
    lx, ly, lz, lt = dims
    b = torch.zeros((lt, lz, ly, lx, 4, 3), dtype=torch.complex128, device=device)
    t, z, y, x = pos
    b[t, z, y, x, column // 3, column % 3] = 1.0
    return b


def _gbar(g):
    gt = GAMMA[3].to(g.device)
    return gt @ g.conj().T @ gt


def proton_density(su: torch.Tensor, sd: torch.Tensor, proj: torch.Tensor,
                   rnd=exact) -> torch.Tensor:
    """su, sd [n, 4, 3, 4, 3] -> the projected proton density [n]."""
    dev = su.device
    g, gb = CGAMMA5.to(dev), _gbar(CGAMMA5.to(dev))
    eps, pr = EPS.to(dev), proj.to(dev)
    out = []
    for lo in range(0, su.shape[0], SITE_CHUNK):
        u, d = su[lo:lo + SITE_CHUNK], sd[lo:lo + SITE_CHUNK]
        w = rnd(torch.einsum("rs,xscuf,uv->xrcvf", g, d, gb))
        a1 = rnd(torch.einsum("abc,def,xbecf->xad", eps, eps,
                              torch.einsum("xrbve,xrcvf->xbecf", u, w)))
        ta = torch.einsum("nm,xmand,xad->x", pr, u, a1)
        bb = rnd(torch.einsum("abc,def,xbdcfnv->xaenv", eps, eps,
                              torch.einsum("xrbnd,xrcvf->xbdcfnv", u, w)))
        out.append(rnd(ta - torch.einsum("nm,xmave,xaenv->x", pr, u, bb)))
    return torch.cat(out)


def meson_density(s1: torch.Tensor, s2: torch.Tensor, gam: torch.Tensor,
                  rnd=exact) -> torch.Tensor:
    """-Tr[Gam S2 Gamb g5 S1^dag g5] at every site; s1, s2 [n, 4, 3, 4, 3]."""
    dev = s1.device
    gm, gb = gam.to(dev), _gbar(gam.to(dev))
    g5 = torch.diagonal(GAMMA5).to(dev)
    out = []
    for lo in range(0, s1.shape[0], SITE_CHUNK):
        a, b = s1[lo:lo + SITE_CHUNK], s2[lo:lo + SITE_CHUNK]
        left = torch.einsum("mr,xravd->xmavd", gm, b)
        right = torch.einsum("vn,xmand->xmavd", gb * g5[None, :],
                             a.conj() * g5[None, :, None, None, None])
        out.append(rnd(-(left * right).sum((1, 2, 3, 4))))
    return torch.cat(out)


def project(dens: torch.Tensor, momenta, src_xyz) -> torch.Tensor:
    """dens [T, Z, Y, X] -> [n_mom, T]; src_xyz = (x0, y0, z0)."""
    lt, lz, ly, lx = dens.shape
    out = []
    x0, y0, z0 = src_xyz
    dev = dens.device
    for px, py, pz in momenta:
        ph = [torch.exp(-2j * torch.pi * p * (torch.arange(n, device=dev, dtype=torch.float64)
                                               - o) / n)
              for p, o, n in ((pz, z0, lz), (py, y0, ly), (px, x0, lx))]
        out.append(torch.einsum("tzyx,z,y,x->t", dens, *ph))
    return torch.stack(out)
