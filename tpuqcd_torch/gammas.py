"""Euclidean gamma matrices in the DeGrand-Rossi basis.

Counterpart of ``tpuqcd/gammas.py`` (the part the twisted-mass and
twisted-clover solves need).  Hermitian gammas, mu = (x, y, z, t), gamma5 = gx gy gz gt =
diag(+1, +1, -1, -1) (the value tpuqcd computes and uses; its docstring
says the opposite signs).  Each Wilson projector (1 -+ gamma_mu) has rank 2
and factors as recon[4, 2] @ proj[2, 4]; every table entry is 0, +-1 or
+-i.  The CUDA kernel (csrc/dslash_eo.cu) hard-codes the same tables.
SIGMA_MUNU[mu, nu] = (i/2)[gamma_mu, gamma_nu] feeds the clover term.
The contraction tables (CGAMMA5, the projectors, EPS3, the meson
channels, the three-point insertions) are products of the same four
matrices.
"""
from __future__ import annotations

import torch

_i = 1j


def _c(rows) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.complex128)


GAMMA = torch.stack([
    _c([[0, 0, 0, _i], [0, 0, _i, 0], [0, -_i, 0, 0], [-_i, 0, 0, 0]]),  # x
    _c([[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]),      # y
    _c([[0, 0, _i, 0], [0, 0, 0, -_i], [-_i, 0, 0, 0], [0, _i, 0, 0]]),  # z
    _c([[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]),        # t
])
GAMMA5 = GAMMA[0] @ GAMMA[1] @ GAMMA[2] @ GAMMA[3]

#: gamma5 is diagonal in this basis: its diagonal, one sign per spin
G5_DIAG = tuple(GAMMA5.diagonal().real.tolist())

#: sigma_{mu nu} = (i/2) [gamma_mu, gamma_nu], [4, 4, 4, 4] complex128
SIGMA_MUNU = 0.5j * (torch.einsum("mab,nbc->mnac", GAMMA, GAMMA)
                     - torch.einsum("nab,mbc->mnac", GAMMA, GAMMA))

HALF_PROJ_MINUS = torch.stack([  # proj for (1 - gamma_mu)
    _c([[1, 0, 0, -_i], [0, 1, -_i, 0]]),
    _c([[1, 0, 0, 1], [0, 1, -1, 0]]),
    _c([[1, 0, -_i, 0], [0, 1, 0, _i]]),
    _c([[1, 0, -1, 0], [0, 1, 0, -1]]),
])
HALF_RECON_MINUS = torch.stack([
    _c([[1, 0], [0, 1], [0, _i], [_i, 0]]),
    _c([[1, 0], [0, 1], [0, -1], [1, 0]]),
    _c([[1, 0], [0, 1], [_i, 0], [0, -_i]]),
    _c([[1, 0], [0, 1], [-1, 0], [0, -1]]),
])
HALF_PROJ_PLUS = torch.stack([  # proj for (1 + gamma_mu)
    _c([[1, 0, 0, _i], [0, 1, _i, 0]]),
    _c([[1, 0, 0, -1], [0, 1, 1, 0]]),
    _c([[1, 0, _i, 0], [0, 1, 0, -_i]]),
    _c([[1, 0, 1, 0], [0, 1, 0, 1]]),
])
HALF_RECON_PLUS = torch.stack([
    _c([[1, 0], [0, 1], [0, -_i], [-_i, 0]]),
    _c([[1, 0], [0, 1], [0, 1], [-1, 0]]),
    _c([[1, 0], [0, 1], [-_i, 0], [0, _i]]),
    _c([[1, 0], [0, 1], [1, 0], [0, 1]]),
])

# --- contraction tables (tpuqcd/gammas.py:107-162) ---------------------------
GAMMA_X, GAMMA_Y, GAMMA_Z, GAMMA_T = GAMMA[0], GAMMA[1], GAMMA[2], GAMMA[3]
ID4 = torch.eye(4, dtype=torch.complex128)
#: charge conjugation C = gamma_y gamma_t; C gamma5 is the diquark vertex
#: of the nucleon interpolating operator
CMAT = GAMMA_Y @ GAMMA_T
CGAMMA5 = CMAT @ GAMMA5

#: parity projectors (1 +- gamma_t) / 2 of the baryon two-point function
PARITY_PLUS = 0.5 * (ID4 + GAMMA_T)
PARITY_MINUS = 0.5 * (ID4 - GAMMA_T)
#: baryon spin projectors: unpolarized, and P5k = (1 + gamma_t)/2 . i g5 g_k
PROJECTORS = {
    "P+": PARITY_PLUS,
    "P-": PARITY_MINUS,
    "P5x": PARITY_PLUS @ (1j * GAMMA5 @ GAMMA_X),
    "P5y": PARITY_PLUS @ (1j * GAMMA5 @ GAMMA_Y),
    "P5z": PARITY_PLUS @ (1j * GAMMA5 @ GAMMA_Z),
}

#: Levi-Civita epsilon_{abc} of the colour contractions, from its definition
EPS3 = torch.tensor([[[(a - b) * (b - c) * (c - a) / 2 for c in range(3)]
                      for b in range(3)] for a in range(3)], dtype=torch.float64)

#: meson interpolators: the correlator is -Tr[Gamma S Gammabar g5 S^dag g5]
#: with the same Gamma at source and sink
MESON_CHANNELS = {
    "a0": ID4,
    "pion": GAMMA5,
    "pion_g4": GAMMA_T @ GAMMA5,
    "b0": GAMMA_T,
    "rho_x": GAMMA_X, "rho_y": GAMMA_Y, "rho_z": GAMMA_Z,
    "a1_x": GAMMA5 @ GAMMA_X,
    "a1_y": GAMMA5 @ GAMMA_Y,
    "a1_z": GAMMA5 @ GAMMA_Z,
}


#: the 16 ultra-local insertions of the three-point run, S = 1, P = g5,
#: V = g_mu, A = g5 g_mu, T = sigma_{mu<nu}; names and order are the HDF5
#: dataset names (tpuqcd/gammas.py:138-151)
INSERTION_GAMMAS = {
    "1": ID4,
    "g5": GAMMA5,
    "gx": GAMMA_X, "gy": GAMMA_Y, "gz": GAMMA_Z, "gt": GAMMA_T,
    "g5gx": GAMMA5 @ GAMMA_X, "g5gy": GAMMA5 @ GAMMA_Y,
    "g5gz": GAMMA5 @ GAMMA_Z, "g5gt": GAMMA5 @ GAMMA_T,
    "sxy": SIGMA_MUNU[0, 1], "sxz": SIGMA_MUNU[0, 2],
    "sxt": SIGMA_MUNU[0, 3], "syz": SIGMA_MUNU[1, 2],
    "syt": SIGMA_MUNU[1, 3], "szt": SIGMA_MUNU[2, 3],
}


def gbar(g: torch.Tensor) -> torch.Tensor:
    """gamma_t g^dag gamma_t, the vertex at the source."""
    return GAMMA_T @ g.mH @ GAMMA_T
