"""tpuqcd_torch — the PyTorch and CUDA port of tpuqcd.

The certified twisted-mass and twisted-clover solves (``cli/run_invert``)
on PyTorch tensors, by CG, BiCGStab or the adaptive multigrid (``mg/``) on
a random or quenched heatbath gauge (``ops/heatbath.py``), with the
even-odd Wilson hop as a hand-written CUDA kernel for Hopper
(``csrc/dslash_eo.cu``, bound in ``ops/dslash_cuda.py``; its epilogues
apply the twisted-mass or clover site term, its leg modes feed the MG
Galerkin probing).  The clover term is ``ops/clover.py``.  On a mesh of
ranks (``parallel/``: one process per card under torchrun) the solves
run sharded, the hop by the kernel's halo mode or by the interior/
exterior split of ``parallel/overlap.py``, the multigrid's fine level in
``mg/shard.py``.  Module names
mirror ``tpuqcd`` so that each counterpart is easy to find; the field
layouts at every public function are the same as there:

    spinor (one parity)  [2(ri), 4, 3, T, Z, S]            S = Y * X/2
    full-system spinor   [2(par), 2(ri), 4, 3, T, Z, S]
    gauge                [4, 2(par), 3, 3, 2(ri), T, Z, S]
    gauge, reconstruct-12 [4, 2(par), 2, 3, 2(ri), T, Z, S]
    MG fine field        [2(ri), 2(par), 4, 3, T, Z, S]
    MG coarse field      [2(ri), N, Tc*Zc*Yc*Xc]
    clover blocks        [2(par), 2(ri), 2(chir), 6, 6, T, Z, S]

The package imports torch and never jax; the device is always explicit.
"""
