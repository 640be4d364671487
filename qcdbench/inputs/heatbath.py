"""Frozen copy of the quenched heatbath chain that makes the benchmark's gauge.

Copied at commit c8a988f from ``tpuqcd_torch/ops/heatbath.py`` (the
chain), ``tpuqcd_torch/ops/gauge_tools.py`` (gauge_sites,
gauge_from_sites, neighbour_tables, link_at, _staple_sum),
``tpuqcd_torch/ops/dslash_cuda.py`` (hop_index), ``tpuqcd_torch/ops/mat3.py``
(mul, trace, det, project_su3), ``tpuqcd_torch/su3.py`` (unit_gauge),
``tpuqcd_torch/ops/layout.py`` (gauge_from_device) and
``tpuqcd_torch/fields.py`` (eo_to_full).  The operations and their order
are unchanged, so with the same torch.Generator seed on the same device
the chain is the port's bit for bit (qcdbench/tests/test_frozen_inputs.py
on the CPU, qcdbench/tools/check_chain.py on the card).  The benchmark
makes its ensemble with this copy, so a later change to the port's
heatbath cannot change the gauge the benchmark measures on.

Wilson plaquette action, Cabibbo-Marinari pseudo-heatbath (Kennedy-Pendleton
above xi = 1, Creutz below) with overrelaxation, one (mu, parity) class of
links at a time; periodic links (the fermion t-phase is not folded in).
Layouts: dims = (Lx, Ly, Lz, Lt); the complex device layout
[4, 2(par), 3, 3, T, Z, S], S = Y * X/2, parity(x) = (t+z+y+x) % 2; the
full layout [4(mu: x, y, z, t), T, Z, Y, X, 3, 3].
"""
from __future__ import annotations

import math

import torch

_SUBGROUPS = ((0, 1), (0, 2), (1, 2))


# --- geometry (lattice.py, dslash_cuda.hop_index, layout.py, fields.py) ------

def site_shape(dims) -> tuple[int, int, int]:
    lx, ly, lz, lt = dims
    return (lt, lz, ly * lx // 2)


def hop_index(dims, src_parity: int, device=None) -> torch.Tensor:
    """int64 [4(mu), 2(fwd, bwd), T*Z*S]: flat site index of the +mu and -mu
    neighbour of every output site, periodic, with the eo x-shift rule."""
    lx, ly, lz, lt = dims
    T, Z, Y, Xh = lt, lz, ly, lx // 2
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    t = ar(T)[:, None, None, None]
    z = ar(Z)[None, :, None, None]
    y = ar(Y)[None, None, :, None]
    xh = ar(Xh)[None, None, None, :]
    o_p = (t + z + y + src_parity) % 2 == 1

    def flat(t_, z_, y_, x_):
        return (((t_ * Z + z_) * Y + y_) * Xh + x_).expand(T, Z, Y, Xh).reshape(-1)

    legs = [
        (flat(t, z, y, torch.where(o_p, xh, (xh + 1) % Xh)),
         flat(t, z, y, torch.where(o_p, (xh - 1) % Xh, xh))),
        (flat(t, z, (y + 1) % Y, xh), flat(t, z, (y - 1) % Y, xh)),
        (flat(t, (z + 1) % Z, y, xh), flat(t, (z - 1) % Z, y, xh)),
        (flat((t + 1) % T, z, y, xh), flat((t - 1) % T, z, y, xh)),
    ]
    return torch.stack([torch.stack(pair) for pair in legs])


def neighbour_tables(dims, device=None):
    return hop_index(dims, 0, device), hop_index(dims, 1, device)


def gauge_sites(u_dev: torch.Tensor) -> torch.Tensor:
    """Device layout [4, 2, 3, 3, T, Z, S] -> site-major [4, 2, T*Z*S, 3, 3]."""
    return u_dev.flatten(4).permute(0, 1, 4, 2, 3).contiguous()


def gauge_from_sites(u_sm: torch.Tensor, dims) -> torch.Tensor:
    """Site-major [4, 2, T*Z*S, 3, 3] -> device layout [4, 2, 3, 3, T, Z, S]."""
    return u_sm.permute(0, 1, 3, 4, 2).reshape(4, 2, 3, 3, *site_shape(dims)).contiguous()


def gauge_device_to_full(u_dev: torch.Tensor, dims) -> torch.Tensor:
    """Device layout [4, 2, 3, 3, T, Z, S] -> full [4, T, Z, Y, X, 3, 3]."""
    lx, ly, lz, lt = dims
    mu, p, i, j, T, Z, S = u_dev.shape
    eo = torch.movedim(u_dev.reshape(mu, p, i, j, T, Z, ly, lx // 2), (2, 3), (6, 7))
    even, odd = eo.select(1, 0), eo.select(1, 1)          # [4, T, Z, Y, Xh, 3, 3]
    t, z, y = (torch.arange(n, device=u_dev.device) for n in (lt, lz, ly))
    s = ((t[:, None, None] + z[None, :, None] + y[None, None, :]) % 2) == 1
    s = s[None, :, :, :, None, None, None]
    pairs = torch.stack([torch.where(s, odd, even), torch.where(s, even, odd)], dim=5)
    return pairs.reshape(4, lt, lz, ly, lx, 3, 3)


# --- 3x3 algebra (mat3.py) ---------------------------------------------------

def mul(a, b, adag: bool = False, bdag: bool = False):
    a = a.mH if adag else a
    b = b.mH if bdag else b
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def trace(a):
    return a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]


def det(a):
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def project_su3(x, iters: int = 6):
    """Newton iteration for unitarity after a Frobenius pre-scale, then a
    det^{-1/3} phase fix."""
    nrm = torch.sqrt(trace(mul(x, x, adag=True)).real / 3.0)
    u = x / nrm[..., None, None]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        u = mul(u, 1.5 * eye - 0.5 * mul(u, u, adag=True))
    phase = torch.exp((-1.0 / 3.0) * 1j * torch.angle(det(u))).to(u.dtype)
    return u * phase[..., None, None]


# --- staples (gauge_tools.py) ------------------------------------------------

def link_at(u_sm, mu: int, parity_of_x: int, shifts, tables):
    tp = parity_of_x ^ (len(shifts) & 1)
    idx, par = None, tp
    for nu, sign in reversed(shifts):
        step = tables[par][nu, 0 if sign > 0 else 1]
        idx = step if idx is None else idx[step]
        par ^= 1
    f = u_sm[mu, tp]
    return f if idx is None else f[idx]


def staple_sum(u_sm, mu: int, p: int, dirs, tables):
    acc = None
    for nu in dirs:
        if nu == mu:
            continue
        t1 = mul(mul(u_sm[nu, p], link_at(u_sm, mu, p, [(nu, +1)], tables)),
                 link_at(u_sm, nu, p, [(mu, +1)], tables), bdag=True)
        a = link_at(u_sm, nu, p, [(nu, -1)], tables)
        b = link_at(u_sm, mu, p, [(nu, -1)], tables)
        c = link_at(u_sm, nu, p, [(nu, -1), (mu, +1)], tables)
        s = t1 + mul(mul(a, b, adag=True), c)
        acc = s if acc is None else acc + s
    return acc


# --- the chain (heatbath.py) -------------------------------------------------

def _quat_of_block(w00, w01, w10, w11):
    a0 = 0.5 * (w00.real + w11.real)
    a1 = 0.5 * (w01.imag + w10.imag)
    a2 = 0.5 * (w01.real - w10.real)
    a3 = 0.5 * (w00.imag - w11.imag)
    k = torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3)
    return (a0, a1, a2, a3), k


def _quat_matrix(q0, q1, q2, q3):
    return (torch.complex(q0, q3), torch.complex(q2, q1), torch.complex(-q2, q1),
            torch.complex(q0, -q3))


def _mul2(a, b):
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
            a10 * b00 + a11 * b10, a10 * b01 + a11 * b11)


def _sample_h0(generator, xi, n_rounds: int = 30):
    dt = xi.dtype
    xi = torch.clamp(xi, min=1e-12)
    use_kp = xi > 1.0
    zmin = torch.exp(-2.0 * xi)
    r = torch.rand((n_rounds, 5, *xi.shape), generator=generator, dtype=dt,
                   device=xi.device)
    r = 1e-10 + (1.0 - 1e-10) * r
    lam2 = -(torch.log(r[:, 0]) + torch.cos(2.0 * math.pi * r[:, 1]) ** 2
             * torch.log(r[:, 2])) / (2.0 * xi)
    kp_ok = r[:, 3] * r[:, 3] <= 1.0 - lam2
    kp_h0 = 1.0 - 2.0 * lam2
    z = zmin + (1.0 - zmin) * r[:, 0]
    cr_h0 = 1.0 + torch.log(z) / xi
    cr_ok = r[:, 4] * r[:, 4] <= 1.0 - cr_h0 * cr_h0
    cand = torch.where(use_kp, kp_h0, cr_h0)
    ok = torch.where(use_kp, kp_ok, cr_ok)
    acc = ok.any(0)
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    h0 = torch.where(acc, cand.gather(0, first[None])[0], torch.ones_like(xi))
    return torch.clamp(h0, -1.0, 1.0), acc


def _su2_heatbath(generator, w_block, beta_eff: float):
    (a0, a1, a2, a3), k = _quat_of_block(*w_block)
    k = torch.clamp(k, min=1e-12)
    h0, acc = _sample_h0(generator, (2.0 * beta_eff) * k)
    n = torch.randn((3, *h0.shape), generator=generator, dtype=h0.dtype, device=h0.device)
    nn = torch.clamp(torch.sqrt(n[0] ** 2 + n[1] ** 2 + n[2] ** 2), min=1e-12)
    hr = torch.sqrt(torch.clamp(1.0 - h0 * h0, min=0.0)) / nn
    h = _quat_matrix(h0, n[0] * hr, n[1] * hr, n[2] * hr)
    g = _mul2(h, _quat_matrix(a0 / k, -a1 / k, -a2 / k, -a3 / k))
    one, zero = torch.ones_like(g[0]), torch.zeros_like(g[0])
    return tuple(torch.where(acc, gi, fi) for gi, fi in zip(g, (one, zero, zero, one)))


def _su2_overrelax(w_block):
    (a0, a1, a2, a3), k = _quat_of_block(*w_block)
    k = torch.clamp(k, min=1e-12)
    vdag = _quat_matrix(a0 / k, -a1 / k, -a2 / k, -a3 / k)
    return _mul2(vdag, vdag)


def _apply_subgroup(m, g, i: int, j: int):
    g00, g01, g10, g11 = (x[:, None] for x in g)
    out = m.clone()
    out[:, i] = g00 * m[:, i] + g01 * m[:, j]
    out[:, j] = g10 * m[:, i] + g11 * m[:, j]
    return out


def _update_class(u_sm, mu: int, p: int, generator, beta: float, tables, overrelax: bool):
    st = staple_sum(u_sm, mu, p, (0, 1, 2, 3), tables)
    link = u_sm[mu, p]
    w = mul(link, st, bdag=True)
    for i, j in _SUBGROUPS:
        block = (w[:, i, i], w[:, i, j], w[:, j, i], w[:, j, j])
        g = (_su2_overrelax(block) if overrelax
             else _su2_heatbath(generator, block, beta / 3.0))
        link = _apply_subgroup(link, g, i, j)
        w = _apply_subgroup(w, g, i, j)
    u_sm[mu, p] = link


def _sweep(u_sm, generator, beta, tables, overrelax: bool):
    for p in (0, 1):
        for mu in range(4):
            _update_class(u_sm, mu, p, generator, beta, tables, overrelax)


def unit_gauge(dims, device=None, dtype=torch.complex64) -> torch.Tensor:
    eye = torch.eye(3, dtype=dtype, device=device).reshape(1, 1, 3, 3, 1, 1, 1)
    return eye.expand(4, 2, 3, 3, *site_shape(dims)).contiguous()


def thermalize(generator: torch.Generator, dims, beta: float, n_sweeps: int,
               n_or: int = 3, reunit_every: int = 20) -> torch.Tensor:
    """n_sweeps compound sweeps (1 heatbath + n_or overrelaxation) from the
    cold start on the generator's device -> the complex64 device-layout
    gauge; links reprojected onto SU(3) every reunit_every sweeps and at
    the end."""
    u0 = unit_gauge(dims, generator.device)
    tables = neighbour_tables(dims, u0.device)
    u_sm = gauge_sites(u0)
    for i in range(int(n_sweeps)):
        _sweep(u_sm, generator, beta, tables, overrelax=False)
        for _ in range(n_or):
            _sweep(u_sm, None, 0.0, tables, overrelax=True)
        if (i + 1) % reunit_every == 0:
            u_sm.copy_(project_su3(u_sm))
    u_sm.copy_(project_su3(u_sm))
    return gauge_from_sites(u_sm, dims)
