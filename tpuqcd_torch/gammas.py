"""Euclidean gamma matrices in the DeGrand-Rossi basis.

Counterpart of ``tpuqcd/gammas.py`` (the part the twisted-mass and
twisted-clover solves need).  Hermitian gammas, mu = (x, y, z, t), gamma5 = gx gy gz gt =
diag(+1, +1, -1, -1) (the value tpuqcd computes and uses; its docstring
says the opposite signs).  Each Wilson projector (1 -+ gamma_mu) has rank 2
and factors as recon[4, 2] @ proj[2, 4]; every table entry is 0, +-1 or
+-i.  The CUDA kernel (csrc/dslash_eo.cu) hard-codes the same tables.
SIGMA_MUNU[mu, nu] = (i/2)[gamma_mu, gamma_nu] feeds the clover term.
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
