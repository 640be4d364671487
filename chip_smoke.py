"""Smoke run of the PyTorch/CUDA port (tpuqcd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card: its name and power limit from nvidia-smi, and
   torch.cuda.get_device_name;
2. the build of tpuqcd_torch/csrc/ with nvcc for sm_90a (dslash_eo_inst.cu
   once per storage type, arithmetic type and link format, side by side,
   linked with dslash_eo.cu) on a thread while 4b's heatbath chain, which
   launches no kernel, runs; its seconds, and ptxas' registers, shared
   bytes and spills of each kernel instantiation, the single, the pair
   (bfloat16, two sites a thread) and the batched kernel apart;
3. the Dslash kernel against its plain PyTorch version on the card, at
   8^3x16 and 32^3x64, in every mode the solves run (epilogues none,
   twist_inv, xpay and xpay with the kappa scale; both source parities;
   dagger off and on) and in each storage type (float64 18-real links,
   float32 and bfloat16 reconstruct-12 links); then the leg modes (K4):
   legs_out with all 8 legs and with a dirs subset given out of order,
   each single dirs leg, and legs_out into the parity views of an MG
   field, in the same parities, daggers and storage types; the clover
   epilogues (K3: clover_inv, clover_xpay and clover_xpay with the kappa
   scale) with a clover term built from the random gauge at csw 1.2, in
   the same parities, daggers and storage types; the MG fine
   operators (DeviceFineLevel.apply and DeviceFineCloverLevel.apply: xpay
   or clover_xpay into the parity views of an MG field, flavor +1 and -1)
   in each storage type; and halo mode (K6) on a one-rank mesh and an
   emulated (nt, nz) = (2, 2) decomposition, each shard's faces cut from
   the global fields with its own t_offset (epilogues none, twist_inv,
   xpay, and the clover epilogues on half-spinor faces; both parities;
   dagger off and on; half-spinor and full faces; float64 and float32
   18-real, float32 and bfloat16 reconstruct-12 links), against the plain
   version and, stitched, against the unsharded kernel; the overlap
   engine (parallel/overlap.py: the interior launch with local-periodic
   wraps, then the slab repairs) on every shard of emulated (2, 2, 1) and
   (2, 1, 2) meshes, every epilogue (none, twist_inv, xpay, xpay with the
   kappa scale, clover_inv, clover_xpay), both parities, dagger off and
   on, float64, float32 and bfloat16, stitched, against the unsharded
   kernel and the plain version; the bfloat16 pair kernel bit for bit
   against the one-site kernel on the same operands at 32^3x64 (every
   epilogue with float32 and bfloat16 arithmetic, both parities, dagger
   off and on, whole, into MG parity views, and in halo mode on the
   one-rank mesh and every (2, 2) shard with half and full faces), within
   1e-2 of the plain version, and Xh odd on the one-site kernel; then the batch
   axis (N = 1, 3, 5 and 12 right-hand sides in one launch at 8^3x16, 5
   a width the batched kernel's column warps do not divide, and
   after 4h-4n at 32^3x64 with exactly the numbers of columns their
   launches had: equal bit for bit to N single launches, within the
   limits of the plain version; every epilogue with clover, both
   parities, dagger, each storage type, and into the parity views of a
   batched MG field), reconstruct-8 (K5:
   every summed epilogue, both parities, dagger, antiperiodic and
   periodic t, each storage type, batched, in halo mode on the (2, 2)
   shards, and against the 18-real kernel on the same links) and
   compute="bf16" (none, twist_inv, xpay, clover:
   against its plain version and against float32 arithmetic, 5% of the
   largest value);
4. the main paths, each with the kernel's launch counts set to 0 just
   before it and read just after (no bfloat16 launch on the one-site
   kernel), the certified residual, and an independent float64 residual
   of the solution through the plain version (an audit of many columns
   takes AUDIT_COLUMNS of them a plain call):
   a. tpuqcd_torch.cli.run_invert at 32^3x64 (random gauge seed 1,
      kappa 0.115, mu 0.08, CG, tol 1e-10);
   b. run_invert's multigrid path at 32^3x64 on the gauge of 4b and every
      later cell: a beta = 6.0 heatbath chain through
      cli/common._heatbath_chain_members (seed 0, 160 compound sweeps to
      member c0000, 20 more to c0001), both written as 64-bit ILDG files
      into a temporary directory removed at exit, and c0000 read back
      through gauge.config_file with its plaquette pinned (its links equal
      to the chain's bit for bit, its checksum verified, both plaquettes
      within 0.002 of 0.5937 and apart; the sweeps', the writes' and the
      read's seconds printed); kappa 0.157, mu 0.0009, mg.preset
      near_critical, inner_tol 1e-7, tol 1e-10; it prints the setup
      seconds by stage, the inner iterations and refinements;
   c. run_invert's direct twisted-clover path at 32^3x64 with the action
      and solver of BASELINE config 2 (random gauge seed 1, kappa 0.115,
      mu 0.06, csw 1.2, BiCGStab on bfloat16 storage, inner_tol 1e-4,
      tol 1e-10); the plain residual applies A directly;
   d. run_invert's twisted-clover multigrid path on the heatbath gauge of
      4b (thermalized once for both): csw 1.769, kappa 0.1352, mu 0.0009,
      near_critical, inner_tol 1e-7, tol 1e-10;
   4b also builds 4b's coarse operator once more by per-leg probing
   (dirs launches) and holds its links against the fused probing's;
   e. run_invert's non-degenerate doublet path at 32^3x64 (random gauge
      seed 1, kappa 0.115, mubar 0.135, epsbar 0.170: ETMC's heavy
      doublet at beta = 1.95, arXiv:1010.3659; CG, tol 1e-10);
   f. the same doublet solve through solve_ndeg_tm_sharded on a one-rank
      LatticeMesh, whose faces are its own boundary slices (halo mode at
      full width), its x held against 4e's;
   g. with more than one card only: torchrun of run_invert on a mesh nt =
      2 or 4 over NCCL, the doublet (x against 4e's), twisted mass under
      fused and under overlap (against 4a's) and MG (against 4b's, the
      gauge read from c0000's file) (with one card it says so and is no
      pass);
   h. tpuqcd_torch.cli.run_twop.measure at 32^3x64 on 4b's gauge, as the
      first member of 4m (the chain's c0000, read from its file), direct
      branch: kappa 0.150, mu 0.005, CG, float32 sloppy, rhs_batch
      12, tol 1e-10, the physics block of examples/twop_mg_24cube.yaml (APE
      0.5 x 5, Gauss 4.0 x 20, source at the origin, momenta (0,0,0) and
      (1,0,0), P+, pion): all 24 columns certified by the solver, one
      column per solver call also by the plain float64 operator, the
      correlators finite, the pion at p = 0 real, positive and equal to the
      sum of |S_u|^2 over each timeslice, the proton and neutron densities
      at 8 sites equal to the unfactored Wick sum; where h5py imports, the
      file is written and read back;
   i. four point-source columns through solve_tm_mg_batch on 4b's
      hierarchy (lockstep GCR), each certified, one held to the plain
      float64 operator, beside the seconds of the first two one by one
      (scaled to four);
   v. 4b's hierarchy with MG's bfloat16 solver buffers (mg.gcr_dtype,
      mg.vec_dtype): its twin from the same null vectors (DeviceMG.rebuilt:
      the bank rounded to bfloat16, Linv from the rounded bank, the
      Galerkin links probed again), 4b's source solved on it to 1e-10:
      certified by the solver and by the plain float64 operator, the inner
      iterations beside 4b's, the solve's peak allocation at least
      PEAK_DROP_SHARE of the reckoned drop (half the GCR basis and half the
      bank) under 4b's solve's, restrict + prolong timed on both banks, and
      more lockstep columns admitted by _check_batch_fits with the
      bfloat16 basis than with the float32 one; and after 4p, the twin of
      4p's sharded hierarchy on the one-rank mesh at 16^3x32 solving 4p's
      source, certified the same way;
   w. solve_certified_batch on 4v's twin at the width the lockstep memory
      check (DeviceMG.batch_buffers) admits with the columns allocated
      (4b's source and point sources at the origin): its first refinement's
      first GCR cycle between the float64 residuals, where the whole
      solve's peak falls (mg_lockstep_memory.py runs the width to the end):
      the peak growth at or below batch_bytes(N), each column's residual
      after the cycle below 1 and equal to the plain float64 operator's on
      the same x, the batched launches; one column more refused before
      allocating;
   x. run_invert's main under torchrun as one rank over NCCL (a process
      group of one) on a heatbath chain of two members at 32^3x64 (10
      sweeps, skip 2, 4a's action), started before phase 3 and run beside
      its checks, which are not timed: the rank generates and writes each
      member behind one all-reduce (cli/common._heatbath_chain_members),
      reads it back and solves on it, every member certified; its files
      byte for byte the same chain generated in this process after 4w;
   o. 4a's twisted-mass and 4c's twisted-clover solves at 16^3x32 (each
      first on one card through run_invert, its twin), then through
      solve_tm_sharded on a one-rank LatticeMesh, under the fused policy
      (halo mode, the shard's own faces) and under overlap (the interior
      launch; one rank has no repairs): certified by the solver and the
      plain float64 operator, x against the twin's within 1e-8;
   p. 4b's recipe at 16^3x32: the beta = 6.0 heatbath gauge of that size
      (seed 0, 160 sweeps), the MG solve on one card (the twin), then
      through the sharded fine level (mg/shard.py, fused, via
      cli/common.MGSolver with a LatticeMesh) on a one-rank mesh from the
      same seed: x against the twin's within 1e-8, certified, the inner
      iterations equal to the twin's, the setup and solve seconds beside
      the twin's;
   q. three columns through ShardedEigCGSolver on a one-rank mesh (4l's
      action, 4p's 16^3x32 gauge) beside the one-card EigCGSolver: x within
      1e-8, the iterations and the space's size equal, each column
      certified;
   r. run_invert's mass sweep at 32^3x64 on c0000 (the physics of
      examples/invert_musweep_32cube.yaml: kappa 0.1373, mu_list 0.009,
      0.018, 0.045, 0.09, CG, the multishift stage to inner_tol 1e-5, then
      every mass certified to 1e-10 from its x_i): every mass certified by
      the solver, by the full-system residual and by the plain float64
      operator; the multishift iterations, the stage's residual and each
      mass's refinement iterations, the seconds, the peak memory; then the
      four masses solved cold by solve_tm one by one, each certified the
      same way, their matvecs and seconds beside the sweep's; and at
      16^3x32 on 4p's gauge the same sweep through solve_tm_musweep and
      certify_musweep on a one-rank LatticeMesh (the sharded fine level,
      solve_tm_sharded) beside one card: every x_i and count bit for bit;
   t. tpuqcd_torch.cli.run_threeptwop.measure (its two-point stages
      included) on a one-rank LatticeMesh at 16^3x32 on 4p's gauge, beside
      its one-card twin: 4j's action, solver and smearing, P5z, the proton,
      the source at (t, z, y, x) = (3, 5, 7, 9), t_sink 15; the mesh run's
      fields are the rank's blocks (ghost layers for the smearing and the
      covariant derivative, the projections summed over the mesh), its
      columns one at a time through the sharded solver, launching halo
      mode (K6) and no batch: every forward and backward column of both runs
      certified by the solver and by the plain float64 operator, every
      dataset within 1e-5 of the twin's largest value, both runs' seconds
      by stage and the mesh run's K6 launches printed;
   u. tpuqcd_torch.cli.run_loops.measure on a one-rank LatticeMesh at
      16^3x32 on 4p's gauge, beside its one-card twin: 4k's physics (TSM,
      8 Lanczos modes to eig_outfile, 33 momenta, the one-derivative
      loops) at 4o's action (kappa 0.115, mu 0.08, CG); the mesh run's
      noises, sources, solutions and basis are the rank's blocks (the
      Lanczos and deflation sums over the mesh, the truncated TSM solves
      and every column one at a time through the sharded operators): every
      full and low-mode column of both runs certified by the solver and by
      the plain float64 operator, the mesh basis orthonormal to 1e-5 with
      positive ascending Rayleigh quotients and its file read back bit for
      bit, every dataset within 1e-5 of the twin's largest value, K6
      launched and no batch, both runs' seconds by stage printed;
   s. BASELINE config 3: a beta = 6.0 heatbath gauge at 24^3x48 (seed 0,
      160 sweeps), the three-level MG of examples/invert_mg3_24cube.yaml
      (near_critical, n_vec 16 and 16, blocks 4^4 and 2^4: 6^3x12, then
      3^3x6) through run_invert, then 4b's two-level recipe on the same
      gauge: each certified by the solver and the plain float64 operator,
      the setup seconds by level, the solve seconds, the inner
      iterations, the coarsest level's dims;
   m. run_twop over the ensemble gauge.config_files = the chain's two
      files, as its main loops it (cli/common.ensemble_members: the second
      file read and checksummed on a background thread while the first
      member runs; setup_gauge, then run_twop.measure with 4h's physics):
      every column of both members certified by the solver and by the
      plain float64 operator, the members' correlators apart, the
      per-member output names '<root>.<file stem><ext>'; the host wait at
      the second member's take beside a synchronous read of its file
      after the run, the read, checksum and decode apart;
   n. setup_gauge on c0000 with gauge.fix landau at tpuqcd's defaults (200
      sweeps, tol 1e-9) on the card: the sweeps, the seconds, the
      functional before, after the first and after the last sweep (held to
      have risen), the plaquette unchanged to 1e-5; and a gauge-invariant
      witness, per timeslice the sum of |x|^2 over the three colour columns
      of source spin 0 from batched CG on the fixed and on the unfixed
      gauge, the two within 1e-5 of the largest value;
   j. tpuqcd_torch.cli.run_threeptwop.measure at 32^3x64 on 4b's gauge
      with 4h's action, solver and smearing, the projectors (P+, P5z) and
      baryons (proton, neutron) of examples/threep.yaml, t_sink 12, sink
      momentum 0: 24 forward and 8 x 12 flavor-flipped backward columns,
      every one certified by the solver and by the plain float64 operator
      (Solver.audit), the proton two-point function equal to 4h's, all
      260 correlators finite, the u / d ratio of the proton's gt insertion
      between source and sink printed, the seconds by stage and the peak
      device memory;
   k. tpuqcd_torch.cli.run_loops.measure at 32^3x64 on 4b's gauge with
      4h's action and solver: one Z4 noise in 12 spin-colour classes, TSM
      with 4 cheap noises (50 steps, tol 1e-3), 8 Lanczos modes of M_d
      M_d^dag written to eig_outfile, the 33 momenta of q^2 <= 4: every
      full and low-mode column certified by the solver and by the plain
      float64 operator, the basis orthonormal to 1e-5 with positive
      ascending Rayleigh quotients (printed with their residuals), every
      deflated source orthogonal to it to 1e-5 of its norm, the file read
      back equal to it bit for bit, every dataset finite of shape
      [n_mom, T]; the TSM correction's size, the seconds by stage and the
      peak device memory printed;
   l. 4k's run without TSM and deflation, with the batched CG and with
      eigCG on the same noise: every column of both held to the plain
      float64 operator, their loops within 1e-6 of each dataset's largest
      value, eigCG's iterations per column and final space printed; then a
      witness that the harvested space deflates, on a fresh right-hand side
      of eigCG's inner system: the share of the plain CG solution's A-norm
      that the space's deflated guess misses (held below 1), the
      iterations without and with the space, the space's lowest Rayleigh
      quotients with their residuals beside a 40-step Lanczos on the same
      operator (the space's lowest held within a factor 2 of Lanczos's),
      and the space's spread lambda_k / lambda_1;
   reconstruct-8 and compute="bf16" are on no path, in tpuqcd as here
   (their only caller is dslash_eo): phases 3 and 5 hold and time them,
   and the kernels line lists them with 0 launches;
5. times at 32^3x64: the kernel per launch for each epilogue and storage
   type the solves use and for the legs_out and dirs modes, and halo mode
   on the one-rank mesh and at the (2, 2) shard size beside the plain hop
   on the same volume, beside the plain version, with GFLOP/s, effective
   GB/s and the bound (compulsory bytes at 3.35 TB/s), each bfloat16 row
   (the pair kernel) with the one-site kernel on the same operands beside
   it, and one dirs leg in halo mode; the batched launch
   at N = 1, 2, 4, 12 and at the numbers of columns 4h's-4n's launches
   had, each beside N single launches of the same columns in the same run
   and their ratio, and twist_inv at 4h's width; reconstruct-8 beside
   reconstruct-12 and 18-real; compute="bf16" beside float32 arithmetic;
   the lockstep CG step at the same N; the heatbath chain's sweeps, the
   ILDG writes and reads (encode, checksum, write; read, checksum,
   decode), the read-ahead's host wait, and the gauge fix; halo mode with
   the twisted-mass and clover epilogues on the one-rank mesh and at the
   (2, 2) shard, the overlap engine (interior and repairs, and the
   interior alone) at the (2, 2, 1) and (2, 1, 2) shards beside the fused
   launch; the solve seconds of 4o-4q beside their twins', 4r's sweep
   beside its cold solves, and 4s's three- and two-level setup and solve.

The line before the last is the JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
tpuqcd_torch package beside this file, it exits with code 1 and prints
no result.  ``--invert-rank`` runs one rank of phase 4g (invert_rank).
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

KAPPA, MU = 0.115, 0.08
SMALL, LARGE = (8, 8, 8, 16), (32, 32, 32, 64)
#: the one-rank mesh cells 4o-4q and the sweep's: each beside its one-card
#: twin at this size (bit for bit at any volume)
MID = (16, 16, 16, 32)
#: cell 4s: BASELINE config 3's volume
MG3_DIMS = (24, 24, 24, 48)
#: the example configurations of cells 4r and 4s
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
#: storage types: (name, dtype, link rows, tolerance on max|k - p| / max|p|)
STORAGE = (("f64", torch.float64, 3, 1e-13),
           ("f32", torch.float32, 2, 1e-5),
           ("bf16", torch.bfloat16, 2, 1e-2))   # about 2 bf16 ulp
#: epilogue modes: (name, epilogue, xpay_scale)
MODES = (("none", "none", None), ("twist_inv", "twist_inv", None),
         ("xpay", "xpay", None), ("xpay_full", "xpay", KAPPA))
#: the multigrid cell: heatbath gauge, near-critical action and preset
MG_KAPPA, MG_MU, MG_BETA, MG_SWEEPS = 0.157, 0.0009, 6.0, 160
PLAQ_BETA6, PLAQ_TOL = 0.5937, 0.002
#: the clover epilogues (K3): (name, epilogue, xpay_scale)
CLOVER_MODES = (("clover_inv", "clover_inv", None), ("clover_xpay", "clover_xpay", None),
                ("clover_xpay_full", "clover_xpay", KAPPA))
#: cell 4c: the action of tests/test_clover.py and BASELINE config 2's
#: solver; with kappa csw = 0.138, |A - 1| <= 0.83 on any gauge
CL_KAPPA, CL_MU, CL_CSW = 0.115, 0.06, 1.2
#: cell 4d: the non-perturbative csw at beta = 6.0 (ALPHA collaboration,
#: hep-lat/9609035) and a kappa near its critical value
MGC_KAPPA, MGC_MU, MGC_CSW = 0.1352, 0.0009, 1.769
#: cell 4e-4g: the heavy doublet (ETMC, beta = 1.95, arXiv:1010.3659)
ND_KAPPA, ND_MUBAR, ND_EPSBAR = 0.115, 0.135, 0.170
#: halo mode's storage types: STORAGE and float32 with 18-real links
HALO_STORAGE = STORAGE[:1] + (("f32_18", torch.float32, 3, 1e-5),) + STORAGE[1:]
#: max |x(4f) - x(4e)| / max |x(4e)|: the same system, certified to 1e-10
#: by two solves whose sloppy operators differ only in summation order
X_AGREE = 1e-8
#: cell 4h: a light quark on the beta = 6.0 heatbath gauge, away from kappa_c
TWOP_KAPPA, TWOP_MU = 0.150, 0.005
#: cells 4b and 4m: the heatbath chain's compound sweeps from member c0000
#: to c0001 (tpuqcd's heatbath_skip default)
CHAIN_SKIP = 20
#: cell 4n: the witness' columns (the three colours of source spin 0)
WITNESS_COLUMNS = 3
#: cell 4j: the sink timeslice, about 1.1 fm from the source at a = 0.093 fm
THREEP_T_SINK = 12
#: cell 4t: the source (t, z, y, x) off the origin and the sink 4j's 12
#: timeslices after it, at MID
MESH_SRC, MESH_T_SINK = (3, 5, 7, 9), 15
#: cells 4t and 4u: max |mesh - twin| / max |twin| of each dataset.  Both
#: runs certify every column to 1e-10; the twin solves 11 columns in
#: lockstep, the mesh one at a time through solve_tm_sharded, so their
#: float32 x differ near 1e-7, which the contractions carry linearly into
#: the correlators and loops
MESH_RUN_AGREE = 1e-5
#: cell 4i: the columns of the lockstep MG solve (12 do not fit the card)
MGB_COLUMNS = 4
#: cell 4w: a column's float64 residual after the lockstep cycle against the
#: plain float64 operator's on the same x, relative (two float64 sums of the
#: same terms in another order)
LOCKSTEP_RES_AGREE = 1e-8
#: cell 4x: the heatbath chain run_invert generates as one rank under
#: torchrun over NCCL: its members, the sweeps to the first, the sweeps
#: between members
CHAIN_RANK_MEMBERS, CHAIN_RANK_SWEEPS, CHAIN_RANK_SKIP = 2, 10, 2
#: cell 4v: the least share of the reckoned drop of the MG solve's peak
#: allocation (half the GCR basis and half the null-vector bank) that the
#: bfloat16 buffers must show against 4b's float32 buffers
PEAK_DROP_SHARE = 0.7
#: cells 4k and 4l: the loop run's deflation modes and its limits on the
#: basis (orthonormality, deflated sources' overlap with it) and, in 4l, on
#: eigCG's loops against the batched CG's (both certified to 1e-10)
LOOPS_N_DEFLATE, BASIS_TOL, LOOPS_AGREE = 8, 1e-5, 1e-6
#: cell 4l's deflation witness: the eigCG space's lowest Rayleigh quotient
#: at most this factor above a 40-step Lanczos's lowest on the same
#: operator (both are upper bounds of the lowest eigenvalue; a space that
#: missed the bottom of the spectrum sits near its mean, orders above)
WITNESS_RQ = 2.0
#: compute="bf16" against float32 arithmetic and its plain version: 5% of
#: the largest value (tpuqcd/tests/test_dslash_pallas.py:269)
BF16C_TOL = 0.05
#: reconstruct-8, (against the plain version, against the 18-real kernel on
#: the rebuilt links): the plain version rebuilds from the same stored
#: reals, so STORAGE's limits hold but for float64 (1e-12: sincos and two
#: square roots a link); the 18-real copy of a bfloat16 link rounds once
#: more (measured at 32^3x64: 4.7e-3 and 5.3e-3; at 8^3x16 6.8e-3)
RECON8_TOL = {"f64": (1e-12, 1e-12), "f32": (1e-5, 1e-5), "bf16": (1e-2, 2e-2)}
FLOP_PER_SITE = 1320
CLOVER_FLOP_PER_SITE = 552   # two 6x6 complex mat-vecs
RELRES_MAX = 1e-10
#: columns of an audit's plain float64 residual in one plain call: the plain
#: version's cost is mostly a call's, not a column's (at 32^3x64 a column
#: alone 0.31-0.39 s, two in one call 0.043 s a column, bit for bit the same
#: residuals; two columns add 7.6 GiB while the call runs, three about 11)
AUDIT_COLUMNS = 2
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, at the 700 W limit
#: peak rates outside the tensor cores (H100 SXM data sheet): bfloat16
#: storage computes in float32
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12, torch.bfloat16: 67e12}


T0 = time.perf_counter()


def say(msg: str) -> None:
    """A phase heading, with the seconds since the script started."""
    print(f"{msg} [at {time.perf_counter() - T0:.0f} s]", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    return line, torch.cuda.get_device_name(0)


def build() -> float:
    """Build the kernel library; print one line per kernel instantiation
    (translation unit, single, pair or batched kernel, its template
    arguments as mangled, registers, shared bytes, spill stores and
    loads)."""
    from tpuqcd_torch.ops.dslash_cuda import library
    library.get()
    return build_report()


def build_report() -> float:
    """build()'s lines for the library already built; its build seconds."""
    from tpuqcd_torch.ops.dslash_cuda import library
    unit = name = spill = ""
    for ln in library.build_log.splitlines():
        if ln.startswith("== "):
            unit = ln[3:]
        elif "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            kind = ("batch " if "batch_kernel" in name else
                    "pair  " if "dslash_eo_kernelILi2E" in name else "single")
            args = re.sub(r"^.*?kernel", "", name).split("Ev")[0]   # the template arguments
            print(f"  ptxas {unit} {kind} {args}: {ln.split(':', 1)[-1].strip()}; {spill}")
            name = spill = ""
    return library.build_seconds


def problem(dims, dev, seed=0):
    """Random gauge with the boundary phase, packed in every storage type,
    and two random spinors of one parity, on ``dev``, drawn there (a
    32^3x64 gauge is 100M normals: on the host they took seconds a call)."""
    from tpuqcd_torch import su3
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.convert import gauge_from_full
    lat = Lattice(dims)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u64 = gauge_from_full(su3.random_gauge(lat, gen, dev, torch.complex128), lat,
                          True, torch.float64, dev)
    gauges = {name: (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
              for name, dt, rows, _ in STORAGE}
    shape = (2, 4, 3, *lat.site_shape)
    psi = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    psi0 = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    return lat, gauges, psi, psi0


def compare(dims, dev) -> dict:
    """Kernel against plain version; returns {storage: max abs err}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(dims, dev)
    max_abs = {}
    for name, dt, _, tol in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        max_abs[name] = 0.0
        for mode, epi, scale in MODES:
            rel = 0.0
            for parity in (0, 1):
                for dagger in (False, True):
                    kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU,
                              psi0=psi0 if epi == "xpay" else None, xpay_scale=scale)
                    k = dslash_eo(u, psi, parity, lat, **kw).double()
                    p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
                    torch.cuda.synchronize()
                    if not torch.isfinite(k).all():
                        fail(f"{dims} {name} {mode}: non-finite kernel output")
                    err = (k - p).abs().max().item()
                    max_abs[name] = max(max_abs[name], err)
                    rel = max(rel, err / p.abs().max().item())
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {mode:9s} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"kernel disagrees with the plain version: {dims} {name} {mode}")
    return max_abs


def compare_legs(dims, dev) -> tuple[dict, dict]:
    """The leg modes (K4) against the plain version; returns {storage:
    max abs err} over the legs_out cases and over the single dirs legs."""
    from tpuqcd_torch.ops.dslash_cuda import LEG_ORDER, dslash_eo, dslash_eo_plain
    lat, gauges, psi64, _ = problem(dims, dev, seed=3)
    subset = ((3, -1), (0, +1), (2, +1))           # out of the kernel's order
    cases = [("legs_out", dict(legs_out=True)),
             ("legs_out_subset", dict(legs_out=True, dirs=subset))]
    cases += [(f"dirs{m}{'+' if s > 0 else '-'}", dict(dirs=((m, s),))) for m, s in LEG_ORDER]
    max_abs, dirs_abs = {}, {}
    for name, dt, _, tol in STORAGE:
        u = gauges[name]
        # psi as the odd-parity view of an MG field [2(ri), 2(par), ...]
        field = torch.stack([psi64, psi64.flip(0)], dim=1).to(dt)
        psi = field[:, 1]
        max_abs[name] = dirs_abs[name] = 0.0
        rel = {}
        for parity in (0, 1):
            for dagger in (False, True):
                for case, kw in cases:
                    k = dslash_eo(u, psi, parity, lat, dagger=dagger, **kw).double()
                    p = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, **kw).double()
                    torch.cuda.synchronize()
                    if not torch.isfinite(k).all():
                        fail(f"{dims} {name} {case}: non-finite kernel output")
                    err = (k - p).abs().max().item()
                    if case.startswith("legs_out"):
                        max_abs[name] = max(max_abs[name], err)
                    else:
                        dirs_abs[name] = max(dirs_abs[name], err)
                    rel[case] = max(rel.get(case, 0.0), err / p.abs().max().item())
                # legs_out written into the parity views of an MG leg bank
                out = torch.empty((8, *field.shape), dtype=dt, device=dev)
                dslash_eo(u, psi, parity, lat, dagger=dagger, legs_out=True, out=out[:, :, 0])
                p = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, legs_out=True)
                torch.cuda.synchronize()
                err = (out[:, :, 0].double() - p.double()).abs().max().item()
                rel["legs_out_view"] = max(rel.get("legs_out_view", 0.0),
                                           err / p.double().abs().max().item())
        for case, r in rel.items():
            ok = r <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {case:15s} "
                  f"max rel err {r:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"leg mode disagrees with the plain version: {dims} {name} {case}")
    return max_abs, dirs_abs


def clover_blocks_of(u_pk, lat, kappa, csw) -> torch.Tensor:
    """The packed float32 A blocks of both parities, [2(par), 2(ri),
    2(chir), 6, 6, T, Z, S], from the gauge's float32 links."""
    from tpuqcd_torch.solve import clover_pk_from_gauge
    return clover_pk_from_gauge(u_pk, lat, kappa=kappa, csw=csw)


def clover_operands(u64, lat, dtype=torch.float64) -> dict:
    """The clover operands of the kernel compares, by epilogue and parity:
    A at csw 1.2 from the float64 gauge (clover_xpay) and its twisted
    inverse (clover_inv), packed [2(par), 2(ri), 2(chir), 6, 6, T, Z, S]."""
    from tpuqcd_torch.ops.clover import clover_twist_inverse
    from tpuqcd_torch.utils.packed import pack_clover
    a_pk = clover_blocks_of(u64, lat, CL_KAPPA, CL_CSW)
    a = torch.complex(a_pk[:, 0], a_pk[:, 1])
    return {"clover_xpay": a_pk.to(dtype),
            "clover_inv": torch.stack([pack_clover(clover_twist_inverse(
                a, CL_KAPPA, CL_MU, 1, par), dtype) for par in (0, 1)])}


def compare_clover(dims, dev) -> dict:
    """The clover epilogues (K3) against the plain version, with A built
    from the random gauge at csw 1.2 (clover_xpay) and its twisted inverse
    (clover_inv) at the output parity; returns {(storage, epilogue): max
    abs err}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=5)
    blocks = clover_operands(gauges["f64"], lat)
    max_abs = {}
    for name, dt, _, tol in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        for mode, epi, scale in CLOVER_MODES:
            rel = 0.0
            for parity in (0, 1):
                cl = blocks[epi][1 - parity].to(dt).contiguous()
                for dagger in (False, True):
                    kw = dict(dagger=dagger, epilogue=epi, kappa=CL_KAPPA, mu=CL_MU, clover=cl,
                              psi0=psi0 if epi == "clover_xpay" else None, xpay_scale=scale)
                    k = dslash_eo(u, psi, parity, lat, **kw).double()
                    p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
                    torch.cuda.synchronize()
                    if not torch.isfinite(k).all():
                        fail(f"{dims} {name} {mode}: non-finite kernel output")
                    err = (k - p).abs().max().item()
                    max_abs[(name, epi)] = max(max_abs.get((name, epi), 0.0), err)
                    rel = max(rel, err / p.abs().max().item())
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {mode:16s} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"clover epilogue disagrees with the plain version: {dims} {name} {mode}")
    return max_abs


def compare_fine_apply(dims, dev, clover: bool = False) -> dict:
    """The MG fine operator M v (mg/device.DeviceFineLevel.apply: xpay with
    the kappa scale, psi0 and out the parity views of an MG field
    [2(ri), 2(par), ...]; with ``clover`` DeviceFineCloverLevel.apply,
    clover_xpay with A at csw 1.769) at the MG cells' kappa and mu,
    flavor +1 and -1 (the CG-NE setup), in each storage type (the float32
    level, its bf16 smoother twin, its float64 certification twin),
    against the plain version on contiguous copies of the same parities;
    returns {storage: max abs err}."""
    from tpuqcd_torch.mg.device import DeviceFineCloverLevel, DeviceFineLevel
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=4)
    field = torch.stack([psi64, psi064], dim=1)           # [2(ri), 2(par), 4, 3, T, Z, S]
    u32 = gauges["f64"].float()
    kappa, mu = (MGC_KAPPA, MGC_MU) if clover else (MG_KAPPA, MG_MU)
    a_pk = clover_blocks_of(u32, lat, kappa, MGC_CSW) if clover else None
    what = "fine clover apply" if clover else "fine apply"
    max_abs = {}
    for flavor in (+1, -1):
        if clover:
            f32 = DeviceFineCloverLevel(lat, u32, a_pk, kappa, mu, flavor=flavor)
        else:
            f32 = DeviceFineLevel(lat, u32, kappa, mu, flavor)
        for name, level in (("f64", f32.as_hp()), ("f32", f32), ("bf16", f32.sloppy())):
            u = level.u_pk if level.u12 is None else level.u12
            tol = next(s[3] for s in STORAGE if s[0] == name)
            v = field.to(u.dtype)
            k = level.apply(v).double()
            p = torch.stack([dslash_eo_plain(
                u, v[:, 1 - par].contiguous(), 1 - par, lat,
                epilogue="clover_xpay" if clover else "xpay", kappa=kappa, mu=mu,
                flavor=flavor, t_boundary=level.t_boundary, psi0=v[:, par].contiguous(),
                xpay_scale=kappa, clover=level.clover_pk[par] if clover else None).double()
                for par in (0, 1)], dim=1)
            torch.cuda.synchronize()
            if not torch.isfinite(k).all():
                fail(f"{dims} {name} {what} flavor {flavor:+d}: non-finite output")
            err = (k - p).abs().max().item()
            max_abs[name] = max(max_abs.get(name, 0.0), err)
            rel = err / p.abs().max().item()
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {what} flavor {flavor:+d} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"MG {what} disagrees with the plain version: {dims} {name} "
                     f"flavor {flavor:+d}")
    return max_abs


def _hop_kw(epi, scale, parity, dt, psi0, blocks):
    """dslash_eo's epilogue arguments of a mode: the clover modes at cell
    4c's action with the blocks of the output parity, the others at
    KAPPA, MU."""
    clover = epi in ("clover_inv", "clover_xpay")
    kw = dict(epilogue=epi, kappa=CL_KAPPA if clover else KAPPA, mu=CL_MU if clover else MU,
              xpay_scale=scale, psi0=psi0 if epi in ("xpay", "clover_xpay") else None)
    if clover:
        kw["clover"] = blocks[epi][1 - parity].to(dt).contiguous()
    return kw


def _local(m, kw):
    """The shard's slices of a hop's spinor and clover operands."""
    return {k: m.shard(v).contiguous() if torch.is_tensor(v) else v for k, v in kw.items()}


def compare_halo(dims, dev) -> dict:
    """Halo mode (K6) on a one-rank mesh (grid (1, 1): the whole lattice,
    its faces its own boundary slices, the shape 4f, 4o-4q launch) and on
    an emulated (2, 2) decomposition (each shard's local fields and faces
    cut from the global ones by parallel/sharded.cut_halo, its own
    t_offset), with the epilogues none, twist_inv, xpay and, but for
    float32 18-real links, the clover epilogues (half-spinor faces, as the
    sharded operators ship them): kernel against the plain version on the
    same operands, and the stitched shards against the unsharded kernel;
    returns {storage: max abs err against the plain version over both
    grids}, and {(storage, clover epilogue): ...} apart."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=6)
    blocks = clover_operands(gauges["f64"], lat)
    grids = {(1, 1): [LatticeMesh(lat, 1, 1, 1, 0)],
             (2, 2): [LatticeMesh(lat, 2, 2, 1, r) for r in range(4)]}
    max_abs = {}
    for name, dt, rows, tol in HALO_STORAGE:
        u = (gauges["f64"] if rows == 3 else gauges["f32"]).to(dt).contiguous()
        psi, psi0 = psi64.to(dt), psi064.to(dt)
        modes = MODES[:3] + (CLOVER_MODES if name != "f32_18" else ())
        for mode, epi, scale in modes:
            key = (name, epi) if epi.startswith("clover") else name
            rel, stitched = dict.fromkeys(grids, 0.0), dict.fromkeys(grids, 0.0)
            for parity in (0, 1):
                for dagger in (False, True):
                    kw = _hop_kw(epi, scale, parity, dt, psi0, blocks)
                    whole = dslash_eo(u, psi, parity, lat, dagger=dagger, **kw).double()
                    for half in ((True,) if key != name else (True, False)):
                        for grid, shards in grids.items():
                            for m in shards:
                                ul, pl, halo = cut_halo(m, u, psi, parity, dagger, half)
                                loc = _local(m, kw)
                                k = dslash_eo(ul, pl, parity, m.local_lat, dagger=dagger,
                                              halo=halo, **loc).double()
                                p = dslash_eo_plain(ul, pl, parity, m.local_lat, dagger=dagger,
                                                    halo=halo, **loc).double()
                                torch.cuda.synchronize()
                                if not torch.isfinite(k).all():
                                    fail(f"{dims} {name} halo {mode} grid {grid}: non-finite "
                                         "kernel output")
                                err = (k - p).abs().max().item()
                                max_abs[key] = max(max_abs.get(key, 0.0), err)
                                rel[grid] = max(rel[grid], err / p.abs().max().item())
                                ref = m.shard(whole)
                                stitched[grid] = max(stitched[grid], (k - ref).abs().max().item()
                                                     / ref.abs().max().item())
            for grid in grids:
                ok = rel[grid] <= tol and stitched[grid] <= tol
                print(f"  {'x'.join(map(str, dims))} {name:6s} halo {mode:16s} grid {grid} "
                      f"max rel err {rel[grid]:.3e} against plain, {stitched[grid]:.3e} "
                      f"{'stitched ' if grid != (1, 1) else ''}against unsharded "
                      f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"halo mode disagrees: {dims} {name} {mode} grid {grid}")
    return max_abs


#: the bfloat16 modes of the pair kernel: MODES and CLOVER_MODES
PAIR_MODES = MODES + CLOVER_MODES


def compare_pairs(dims, dev) -> dict:
    """The pair kernel (two sites a thread, bfloat16x2 accesses) against the
    one-site kernel on the same operands (ops/dslash_cuda.dslash_eo_one_site),
    bit for bit, in every bfloat16 mode: PAIR_MODES with float32 and
    (PAIR_MODES but the clover xpay scale) bfloat16 arithmetic, both
    parities, dagger off and on; whole, in halo mode on the one-rank mesh
    and on every shard of the emulated (2, 2) decomposition with
    half-spinor and full faces, and into the parity views of an MG field;
    and against the plain version (STORAGE's 1e-2; BF16C_TOL for bfloat16
    arithmetic) at parity 0, dagger off.  The pair launch counts under the
    mode's key, the one-site launch under the same key with ":one_site".
    A lattice with Xh odd (10x4x4x8) takes the one-site kernel.  Returns
    {(compute, mode): max abs err of the pair kernel against the plain
    version}."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_one_site, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=10)
    blocks = clover_operands(gauges["f64"], lat)
    u, psi, psi0 = gauges["bf16"], psi64.bfloat16(), psi064.bfloat16()
    field = torch.stack([psi, psi0], dim=1)                 # [2(ri), 2(par), ...]
    meshes = [LatticeMesh(lat, 1, 1, 1, 0)] + [LatticeMesh(lat, 2, 2, 1, r) for r in range(4)]
    max_abs = {}

    def same(k, o, what):
        torch.cuda.synchronize()
        if not torch.isfinite(k.float()).all():
            fail(f"{what}: non-finite pair kernel output")
        if not torch.equal(k, o):
            d = (k.double() - o.double()).abs().max().item()
            fail(f"{what}: the pair kernel differs from the one-site kernel by {d:.3e}")

    for compute in ("f32", "bf16"):
        tol = 1e-2 if compute == "f32" else BF16C_TOL
        for mode, epi, scale in PAIR_MODES:
            if compute == "bf16" and mode == "clover_xpay_full":
                continue
            n_same, rel = 0, 0.0
            for parity in (0, 1):
                for dagger in (False, True):
                    kw = _hop_kw(epi, scale, parity, torch.bfloat16, psi0, blocks)
                    kw.update(dagger=dagger, compute=compute)
                    what = (f"{'x'.join(map(str, dims))} pair {compute} {mode} parity {parity} "
                            f"dagger {dagger}")
                    dslash_cuda.reset_counts()
                    k = dslash_eo(u, psi, parity, lat, **kw)
                    o = dslash_eo_one_site(u, psi, parity, lat, **kw)
                    keys = sorted(dslash_cuda.counts)
                    if len(keys) != 2 or keys[1] != keys[0] + ":one_site":
                        fail(f"{what}: launch keys {keys}")
                    same(k, o, what)
                    n_same += 1
                    if (parity, dagger) == (0, False):
                        p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
                        err = (k.double() - p).abs().max().item()
                        max_abs[(compute, mode)] = err
                        rel = err / p.abs().max().item()
                    # into the parity views of an MG field, psi0 the other parity
                    a, b = torch.empty_like(field), torch.empty_like(field)
                    kv = dict(kw, psi0=field[:, parity] if kw["psi0"] is not None else None)
                    dslash_eo(u, field[:, 1 - parity], 1 - parity, lat, out=a[:, parity], **kv)
                    dslash_eo_one_site(u, field[:, 1 - parity], 1 - parity, lat, out=b[:, parity],
                                       **kv)
                    same(a[:, parity], b[:, parity], what + " MG views")
                    n_same += 1
                    for m in meshes:
                        for half in (True, False):
                            ul, pl, halo = cut_halo(m, u, psi, parity, dagger, half)
                            loc = _local(m, kw)
                            k = dslash_eo(ul, pl, parity, m.local_lat, halo=halo, **loc)
                            o = dslash_eo_one_site(ul, pl, parity, m.local_lat, halo=halo, **loc)
                            same(k, o, f"{what} halo grid {(m.nt, m.nz)} rank {m.rank} "
                                 f"{'half' if half else 'full'} faces")
                            n_same += 1
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} bf16 pair {compute} {mode:16s} bit for bit the "
                  f"one-site kernel in {n_same} launches (whole, MG views, halo (1, 1) and (2, 2) "
                  f"half and full); max rel err {rel:.3e} against plain (tol {tol:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the pair kernel disagrees with the plain version: {dims} {compute} {mode}")
    # Xh odd: pair_sites refuses, the one-site kernel runs and counts so
    odd = Lattice((10, 4, 4, 8))
    _, g_odd, x64, _ = problem(odd.dims, dev, seed=11)
    dslash_cuda.reset_counts()
    k = dslash_eo(g_odd["bf16"], x64.bfloat16(), 0, odd, epilogue="twist_inv", kappa=KAPPA, mu=MU)
    p = dslash_eo_plain(g_odd["bf16"], x64.bfloat16(), 0, odd, epilogue="twist_inv", kappa=KAPPA,
                        mu=MU).double()
    rel = _agree(k, p, "Xh odd, the one-site kernel", 1e-2)[1]
    if dict(dslash_cuda.counts) != {"bfloat16:one_site": 1, "plain": 1}:
        fail(f"Xh odd: launch keys {dict(dslash_cuda.counts)}, not bfloat16:one_site")
    print(f"  10x4x4x8 (Xh odd) bf16 twist_inv: one-site kernel (bfloat16:one_site), max rel err "
          f"{rel:.3e} against plain")
    return max_abs


#: the overlap engine's emulated meshes (t, z, y) and its epilogues
OVERLAP_GRIDS = ((2, 2, 1), (2, 1, 2))
OVERLAP_MODES = MODES + CLOVER_MODES[:2]


def compare_overlap(dims, dev) -> dict:
    """The overlap engine (parallel/overlap.dslash_overlap: the interior
    launch on the shard's lattice with local-periodic wraps, the slab
    repairs) on every shard of emulated (2, 2, 1) and (2, 1, 2) meshes, the
    faces cut from the global fields (parallel/sharded.cut_halo): every
    epilogue, both parities, dagger off and on, in each storage type; the
    stitched result against the unsharded kernel and against the plain
    version, STORAGE's limits on max|err| / max|ref|; returns {storage:
    max abs err against the plain version}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.overlap import dslash_overlap
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=8)
    blocks = clover_operands(gauges["f64"], lat)
    max_abs = {}
    for name, dt, _, tol in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        max_abs[name] = 0.0
        for mode, epi, scale in OVERLAP_MODES:
            rel_k, rel_p = dict.fromkeys(OVERLAP_GRIDS, 0.0), dict.fromkeys(OVERLAP_GRIDS, 0.0)
            for parity in (0, 1):
                for dagger in (False, True):
                    kw = _hop_kw(epi, scale, parity, dt, psi0, blocks)
                    whole = dslash_eo(u, psi, parity, lat, dagger=dagger, **kw).double()
                    plain = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, **kw).double()
                    for grid in OVERLAP_GRIDS:
                        out = torch.empty_like(whole)
                        for r in range(int(np.prod(grid))):
                            m = LatticeMesh(lat, *grid, r)
                            ul, pl, halo = cut_halo(m, u, psi, parity, dagger)
                            m.shard(out)[...] = dslash_overlap(ul, pl, parity, m, halo,
                                                               dagger=dagger, **_local(m, kw))
                        torch.cuda.synchronize()
                        if not torch.isfinite(out).all():
                            fail(f"{dims} {name} overlap {mode} grid {grid}: non-finite output")
                        err = (out - plain).abs().max().item()
                        max_abs[name] = max(max_abs[name], err)
                        rel_p[grid] = max(rel_p[grid], err / plain.abs().max().item())
                        rel_k[grid] = max(rel_k[grid], (out - whole).abs().max().item()
                                          / whole.abs().max().item())
            for grid in OVERLAP_GRIDS:
                ok = rel_p[grid] <= tol and rel_k[grid] <= tol
                print(f"  {'x'.join(map(str, dims))} {name:4s} overlap {mode:11s} grid {grid} "
                      f"stitched max rel err {rel_p[grid]:.3e} against plain, {rel_k[grid]:.3e} "
                      f"against the unsharded kernel (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"the overlap engine disagrees: {dims} {name} {mode} grid {grid}")
    return max_abs


def _agree(k, p, what, tol, bitwise=False) -> tuple[float, float]:
    """(max abs err, max abs err / max|p|) of k against p; fails on a
    non-finite k, on more than tol, or (bitwise) on any difference."""
    k, p = k.double(), p.double()
    torch.cuda.synchronize()
    if not torch.isfinite(k).all():
        fail(f"{what}: non-finite kernel output")
    err = (k - p).abs().max().item()
    rel = err / p.abs().max().item()
    if (bitwise and err != 0.0) or rel > tol:
        fail(f"{what}: max rel err {rel:.3e} (limit {'bit for bit' if bitwise else tol})")
    return err, rel


def compare_batch(dims, dev, widths) -> dict:
    """The batch axis: N right-hand sides in one launch, for every N of
    ``widths``, against N single launches (bit for bit) and against the
    plain version on the batch, every epilogue with the clover ones, both
    parities, dagger off and on, each storage type; psi, psi0 and out the
    parity views of a batched MG field [N, 2(ri), 2(par), ...]; returns
    {(storage, N): max abs err against the plain version}.  The launch of
    width N takes the first N columns of one field as wide as the widest,
    so the plain version runs once on the widest and every column of every
    launch is held against it."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, _, _ = problem(dims, dev, seed=8)
    blocks = clover_operands(gauges["f64"], lat)
    gen = torch.Generator(device=dev).manual_seed(18)
    nmax = max(widths)
    max_abs = {}
    # the whole matrix at the small size; at full size dagger on at source
    # parity 1 only
    full = dims == SMALL
    for name, dt, _, tol in STORAGE:
        u = gauges[name]
        worst = 0.0
        for n in widths:
            max_abs[(name, n)] = 0.0
        field_all = torch.randn((nmax, 2, 2, 4, 3, *lat.site_shape), generator=gen,
                                device=dev).to(dt)
        field0_all = field_all.flip(0).roll(1, 2)
        for parity in (0, 1):
            for dagger in (False, True) if full else (parity == 1,):
                for mode, epi, scale in MODES + CLOVER_MODES[:2]:
                    cl = (blocks[epi][1 - parity].to(dt).contiguous()
                          if epi in blocks else None)
                    kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU,
                              xpay_scale=scale, clover=cl)
                    need0 = epi.endswith("xpay")
                    # the plain version on the widest batch, or at full size on
                    # 3 columns at a time (its temporaries are some twenty fields
                    # a column)
                    step = nmax if full else 3
                    plain = torch.cat([dslash_eo_plain(
                        u, field_all[lo:lo + step, :, parity], parity, lat,
                        psi0=field0_all[lo:lo + step, :, 1 - parity] if need0 else None, **kw)
                        for lo in range(0, nmax, step)])
                    for n in widths:
                        field, field0 = field_all[:n], field0_all[:n]
                        psi, psi0 = field[:, :, parity], field0[:, :, 1 - parity]
                        what = f"{dims} {name} batch N={n} {mode} p{parity} dagger={dagger}"
                        out = torch.zeros_like(field)
                        k = dslash_eo(u, psi, parity, lat, psi0=psi0 if need0 else None,
                                      out=out[:, :, 1 - parity], **kw)
                        for i in range(n):
                            single = dslash_eo(u, psi[i], parity, lat,
                                               psi0=psi0[i] if need0 else None, **kw)
                            _agree(k[i], single, what + " against single launches", 0.0,
                                   bitwise=True)
                        del single
                        err, rel = _agree(k, plain[:n], what + " against plain", tol)
                        if out[:, :, parity].abs().max().item() != 0.0:
                            fail(what + ": wrote outside its parity view")
                        del out, k
                        max_abs[(name, n)], worst = max(max_abs[(name, n)], err), max(worst, rel)
                    del plain
        del field_all, field0_all
        print(f"  {'x'.join(map(str, dims))} {name:4s} batch N={','.join(map(str, widths))}, 6 "
              f"epilogues, parities, {'daggers' if full else 'dagger at parity 1'}: equal to "
              f"single launches bit for bit; max rel err against plain "
              f"{worst:.3e} (tol {tol:.0e}) ok")
    return max_abs


def gauges8(gauges) -> dict:
    """The reconstruct-8 copies of problem()'s float64 18-real gauge, by
    storage name."""
    from tpuqcd_torch.utils.packed import pack_gauge8, unpack_gauge
    uc = unpack_gauge(gauges["f64"])
    return {name: pack_gauge8(uc, dt) for name, dt, _, _ in STORAGE}


def compare_recon8(dims, dev) -> dict:
    """Reconstruct-8 (K5) against the plain version and against the
    18-real kernel on the same links (the rebuilt link of the stored 8
    reals, utils.packed.unpack_gauge8 with the boundary phase put back):
    every summed epilogue, both parities, dagger off and on, antiperiodic
    and periodic t, each storage type, also a batch of 3, and in halo mode
    on an emulated (2, 2) decomposition (the boundary phase by each shard's
    t_offset; against the plain version and, stitched, bit for bit against
    the unsharded reconstruct-8 kernel); returns {storage: max abs err
    against the plain version}."""
    from tpuqcd_torch import su3
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    from tpuqcd_torch.utils.convert import gauge_from_full
    from tpuqcd_torch.utils.packed import pack_gauge, pack_gauge8, unpack_gauge, unpack_gauge8
    lat = Lattice(dims)
    shards = [LatticeMesh(lat, 2, 2, 1, r) for r in range(4)]
    gen = torch.Generator(device=dev).manual_seed(9)
    u_full = su3.random_gauge(lat, gen, dev, torch.complex128)
    shape = (3, 2, 4, 3, *lat.site_shape)
    psi64 = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    psi064 = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    max_abs = {}
    for name, dt, _, _ in STORAGE:
        tol, tol18 = RECON8_TOL[name]
        max_abs[name] = 0.0
        worst, worst18 = 0.0, 0.0
        for tb in (-1, 1):
            u64 = gauge_from_full(u_full, lat, tb == -1, torch.float64, dev)
            u8 = pack_gauge8(unpack_gauge(u64), dt)
            # the links the 8 stored reals stand for, as an 18-real gauge
            u18 = unpack_gauge8(u8)
            if tb == -1:
                u18[3, :, 2, :, lat.Lt - 1] *= -1
            u18 = pack_gauge(u18, dt).contiguous()
            psi, psi0 = psi64.to(dt), psi064.to(dt)
            for mode, epi, scale in MODES:
                for parity in (0, 1):
                    # every pairing at the small size; at full size dagger
                    # on at source parity 1 only
                    for dagger in (False, True) if dims == SMALL else (parity == 1,):
                        kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU,
                                  xpay_scale=scale, t_boundary=tb)
                        p0 = psi0 if epi == "xpay" else None
                        what = f"{dims} {name} recon-8 {mode} p{parity} dagger={dagger} tb={tb}"
                        k = dslash_eo(u8, psi, parity, lat, psi0=p0, **kw)
                        p = dslash_eo_plain(u8, psi, parity, lat, psi0=p0, **kw)
                        err, rel = _agree(k, p, what + " against plain", tol)
                        k18 = dslash_eo(u18, psi, parity, lat, psi0=p0, **kw)
                        _, rel18 = _agree(k, k18, what + " against the 18-real kernel", tol18)
                        k1 = dslash_eo(u8, psi[1], parity, lat,
                                       psi0=None if p0 is None else p0[1], **kw)
                        _agree(k[1], k1, what + " batch against a single launch", 0.0, True)
                        max_abs[name] = max(max_abs[name], err)
                        worst, worst18 = max(worst, rel), max(worst18, rel18)
            for parity in (0, 1):
                whole = dslash_eo(u8, psi[0], parity, lat, t_boundary=tb)
                for m in shards:
                    what = f"{dims} {name} recon-8 halo p{parity} tb={tb} shard {m.coords}"
                    ul, pl, halo = cut_halo(m, u8, psi[0], parity)
                    k = dslash_eo(ul, pl, parity, m.local_lat, halo=halo, t_boundary=tb)
                    p = dslash_eo_plain(ul, pl, parity, m.local_lat, halo=halo, t_boundary=tb)
                    err, rel = _agree(k, p, what + " against plain", tol)
                    _agree(k, m.shard(whole), what + " against the unsharded kernel", 0.0, True)
                    max_abs[name], worst = max(max_abs[name], err), max(worst, rel)
        print(f"  {'x'.join(map(str, dims))} {name:4s} recon-8, 4 epilogues, parities, daggers, "
              f"t_boundary -1 and +1, batch of 3, (2, 2) halo shards: max rel err {worst:.3e} "
              f"against plain, "
              f"{worst18:.3e} against the 18-real kernel on the same links (tol {tol:.0e}, "
              f"{tol18:.0e}) ok")
    return max_abs


def compare_bf16c(dims, dev) -> float:
    """compute="bf16" against its plain version and against the kernel's
    float32 arithmetic on the same bfloat16 operands, 5% of max|ref|:
    none, twist_inv, xpay and the clover epilogues, both parities, dagger,
    single and a batch of 3; returns the max abs err against plain."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, _, _ = problem(dims, dev, seed=10)
    blocks = clover_operands(gauges["f64"], lat, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(20)
    shape = (3, 2, 4, 3, *lat.site_shape)
    psi = torch.randn(shape, generator=gen, device=dev).bfloat16()
    psi0 = torch.randn(shape, generator=gen, device=dev).bfloat16()
    u = gauges["bf16"]
    max_abs = 0.0
    for mode, epi, scale in MODES[:3] + CLOVER_MODES[:2]:
        worst_p, worst_f = 0.0, 0.0
        for parity in (0, 1):
            cl = blocks[epi][1 - parity].bfloat16().contiguous() if epi in blocks else None
            for dagger in (False, True) if dims == SMALL else (parity == 1,):
                kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, clover=cl,
                          psi0=psi0 if epi.endswith("xpay") else None)
                what = f"{dims} compute=bf16 {mode} p{parity} dagger={dagger}"
                k = dslash_eo(u, psi, parity, lat, compute="bf16", **kw)
                p = dslash_eo_plain(u, psi, parity, lat, compute="bf16", **kw)
                f = dslash_eo(u, psi, parity, lat, **kw)
                err, rel_p = _agree(k, p, what + " against plain", BF16C_TOL)
                _, rel_f = _agree(k, f, what + " against float32 arithmetic", BF16C_TOL)
                k1 = dslash_eo(u, psi[1], parity, lat, compute="bf16",
                               **{**kw, "psi0": None if kw["psi0"] is None else psi0[1]})
                _agree(k[1], k1, what + " batch against a single launch", 0.0, True)
                max_abs, worst_p, worst_f = max(max_abs, err), max(worst_p, rel_p), max(worst_f, rel_f)
        print(f"  {'x'.join(map(str, dims))} compute=bf16 {mode:11s} max rel err {worst_p:.3e} "
              f"against plain, {worst_f:.3e} against float32 arithmetic (tol {BF16C_TOL}) ok")
    for dt in (torch.float32, torch.float64):
        refused = False
        try:
            dslash_eo(gauges["f32"].to(dt), psi[0].to(dt), 0, lat, compute="bf16")
        except ValueError:
            refused = True
        if not refused:
            fail(f"compute='bf16' with {dt} storage did not raise")
    return max_abs



def plain_full_relres(u64, b, x, lat, kappa=KAPPA, mu=MU, a64=None) -> float:
    """|b - M x| / |b| of the two-parity system with the plain version;
    with the A blocks a64 [2(par), 2(ri), 2(chir), 6, 6, T, Z, S] the
    twisted-clover M, A applied directly beside the plain hop."""
    from tpuqcd_torch.operators import gamma5_apply_pk
    from tpuqcd_torch.ops.clover import clover_apply_pk
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    if a64 is None:
        m = [dslash_eo_plain(u64, x[1 - par].contiguous(), 1 - par, lat, epilogue="xpay",
                             kappa=kappa, mu=mu, psi0=x[par].contiguous(), xpay_scale=kappa)
             for par in (0, 1)]
    else:
        tw = 2.0 * kappa * mu
        m = []
        for par in (0, 1):
            g = gamma5_apply_pk(x[par])
            site = clover_apply_pk(a64[par], x[par]) + tw * torch.stack([-g[1], g[0]])
            m.append(site - kappa * dslash_eo_plain(u64, x[1 - par].contiguous(), 1 - par, lat))
    r = b - torch.stack(m)
    return (r.square().sum() / b.square().sum()).sqrt().item()


def plain_relres_cols(u64, b, x, lat, kappa=KAPPA, mu=MU) -> list:
    """plain_full_relres of every column of b, x [N, 2(par), 2(ri), 4, 3, T,
    Z, S], AUDIT_COLUMNS columns a plain call (its batch axis): the same
    float64 residuals, without the plain version's cost a call for each.
    A call of one column costs what an unbatched call does, so an odd
    count's last three columns go together and a lone column is paired
    with itself (its second residual dropped)."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    n = b.shape[0]
    starts = list(range(0, n - 1, AUDIT_COLUMNS)) if n > 1 else [0]
    out = []
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else n
        bs, xs = b[s:e].double(), x[s:e]
        if e - s == 1:
            bs, xs = bs.expand(2, *bs.shape[1:]), xs.expand(2, *xs.shape[1:])
        m = [dslash_eo_plain(u64, xs[:, 1 - par].contiguous(), 1 - par, lat, epilogue="xpay",
                             kappa=kappa, mu=mu, psi0=xs[:, par].contiguous(),
                             xpay_scale=kappa)
             for par in (0, 1)]
        r = bs - torch.stack(m, dim=1)
        rel = (r.square().flatten(1).sum(1) / bs.square().flatten(1).sum(1)).sqrt().tolist()
        out += rel[:e - s]
    return out


def counted_invert(cfg, dev, gauge=None, flavors=False, dims=LARGE):
    """run_invert's invert with the launch counts set to 0 just before and
    read just after; returns (result, counts).  ``flavors``: x is a
    doublet [2(fl), 2(par), ...]; ``dims`` the lattice x is checked on."""
    from tpuqcd_torch.cli.run_invert import invert
    from tpuqcd_torch.ops import dslash_cuda
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    res = invert(cfg, dev, gauge)
    torch.cuda.synchronize()
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the main path called the plain version {counts['plain']} times")
    if not (res.relres <= RELRES_MAX and res.solver_relres <= RELRES_MAX
            and torch.isfinite(res.x).all()):
        fail(f"certified relres {res.relres:.3e} / {res.solver_relres:.3e} > "
             f"{RELRES_MAX:.0e} or non-finite x")
    want = (2,) * (3 if flavors else 2) + (4, 3, dims[3], dims[2], dims[1] * dims[0] // 2)
    if tuple(res.x.shape) != want:
        fail(f"solution shape {tuple(res.x.shape)}, not {want}")
    return res, counts


def need_launches(counts, keys) -> None:
    """Fails unless the path launched each kernel of keys, and if any of its
    bfloat16 single launches took the one-site kernel (every operand of the
    main paths is one the pair kernel takes)."""
    for key in keys:
        if counts.get(key, 0) <= 0:
            fail(f"the main path did not launch the {key} kernel: {counts}")
    one_site = {k: v for k, v in counts.items() if k.endswith(":one_site") and v}
    if one_site:
        fail(f"the main path's bfloat16 launches took the one-site kernel: {one_site}")


def check_plain(res, lat, kappa, mu, csw=0.0) -> float:
    """The independent float64 residual of a main path's solution."""
    a64 = clover_blocks_of(res.u_pk, lat, kappa, csw).double() if csw else None
    rel = plain_full_relres(res.u_pk.double(), res.b_pk.double(), res.x, lat, kappa, mu, a64)
    print(f"  certified relres {res.relres:.3e} (solver's own {res.solver_relres:.3e}), "
          f"plain-operator relres {rel:.3e}, iterations {res.iters}, "
          f"refinements {res.refinements}, solve wallclock {res.seconds:.3f} s")
    if not rel <= RELRES_MAX:
        fail(f"plain-operator relres {rel:.3e} > {RELRES_MAX:.0e}")
    return rel


def main_path(dev, dims=LARGE):
    """run_invert's direct path: CG on the twisted-mass system (4a; at MID
    the twin of 4o)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "gauge": {"dims": list(dims), "random_seed": 1},
        "action": {"kappa": KAPPA, "mu": MU},
        "solver": {"solver": "cg", "tol": RELRES_MAX}})
    res, counts = counted_invert(cfg, dev, dims=dims)
    need_launches(counts, ("float32", "float64"))
    check_plain(res, Lattice(dims), KAPPA, MU)
    return res, counts


def clover_path(dev, dims=LARGE):
    """run_invert's direct twisted-clover path, BASELINE config 2's action
    and solver at 32^3x64 (4c; at MID the twin of 4o)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "gauge": {"dims": list(dims), "random_seed": 1},
        "action": {"kappa": CL_KAPPA, "mu": CL_MU, "csw": CL_CSW},
        "solver": {"solver": "bicgstab", "sloppy_dtype": "bfloat16", "inner_tol": 1e-4,
                   "tol": RELRES_MAX}})
    res, counts = counted_invert(cfg, dev, dims=dims)
    print(f"  clover term and twisted inverses {res.setup_seconds['clover']:.3f} s")
    need_launches(counts, ("bfloat16:clover_inv", "bfloat16:clover_xpay",
                           "float64:clover_inv", "float64:clover_xpay"))
    check_plain(res, Lattice(dims), CL_KAPPA, CL_MU, CL_CSW)
    return res, counts


def plain_ndeg_relres(u64, b, x, lat) -> float:
    """|b - M_nd x| / |b| of the two-parity doublet system with the plain
    hop and the site term A = 1 + i t g5 tau3 + e tau1 written out."""
    from tpuqcd_torch.operators import gamma5_apply_pk
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    tw, e = 2.0 * ND_KAPPA * ND_MUBAR, 2.0 * ND_KAPPA * ND_EPSBAR
    r = []
    for par in (0, 1):
        for f, sign in ((0, 1.0), (1, -1.0)):
            g = gamma5_apply_pk(x[f, par])
            site = x[f, par] + sign * tw * torch.stack([-g[1], g[0]]) + e * x[1 - f, par]
            hop = dslash_eo_plain(u64, x[f, 1 - par].contiguous(), 1 - par, lat)
            r.append(b[f, par] - (site - ND_KAPPA * hop))
    r = torch.stack(r)
    return (r.square().sum() / b.square().sum()).sqrt().item()


def ndeg_dict(mesh_nt: int = 1) -> dict:
    """The run config of cells 4e-4g, as a dict."""
    return {"gauge": {"dims": list(LARGE), "random_seed": 1},
            "action": {"kappa": ND_KAPPA, "mubar": ND_MUBAR, "epsbar": ND_EPSBAR},
            "solver": {"solver": "cg", "tol": RELRES_MAX}, "mesh": {"nt": mesh_nt}}


def ndeg_config(mesh_nt: int = 1):
    from tpuqcd_torch.utils.config import config_from_dict
    return config_from_dict(ndeg_dict(mesh_nt))


def ndeg_path(dev):
    """run_invert's non-degenerate doublet path on one card (4e)."""
    from tpuqcd_torch.lattice import Lattice
    res, counts = counted_invert(ndeg_config(), dev, flavors=True)
    need_launches(counts, ("float32", "float64"))
    rel = plain_ndeg_relres(res.u_pk.double(), res.b_pk.double(), res.x, Lattice(LARGE))
    print(f"  certified doublet relres {res.relres:.3e} (solver's own {res.solver_relres:.3e}), "
          f"plain-operator relres {rel:.3e}, iterations {res.iters}, refinements "
          f"{res.refinements}, solve wallclock {res.seconds:.3f} s")
    if not rel <= RELRES_MAX:
        fail(f"plain-operator doublet relres {rel:.3e} > {RELRES_MAX:.0e}")
    return res, counts


def sharded_path(dev, nd_res):
    """4e's doublet solve through solve_ndeg_tm_sharded on a one-rank
    LatticeMesh (4f): every hop in halo mode, its faces the shard's own
    boundary slices.  Returns (seconds, counts)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import ShardedNdegTMOperatorPC
    from tpuqcd_torch.solve import solve_ndeg_tm_sharded
    lat = Lattice(LARGE)
    lmesh = LatticeMesh.make(lat, 1)
    op = ShardedNdegTMOperatorPC(lat, kappa=ND_KAPPA, mubar=ND_MUBAR, epsbar=ND_EPSBAR,
                                 lmesh=lmesh)
    ug = op.extend_gauge(nd_res.u_pk)
    fields_s, fields_hp = ug.to(torch.float32, rows=2), ug.to(torch.float64)
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    res = solve_ndeg_tm_sharded(op, fields_s, fields_hp, nd_res.b_pk, tol=RELRES_MAX)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the sharded path called the plain version {counts['plain']} times")
    need_launches(counts, ("float32:halo", "float64:halo"))
    rel = plain_ndeg_relres(nd_res.u_pk.double(), nd_res.b_pk.double(), res.x, lat)
    agree = ((res.x - nd_res.x).abs().max() / nd_res.x.abs().max()).item()
    print(f"  certified relres {res.relres:.3e} (4e: {nd_res.solver_relres:.3e}), "
          f"plain-operator relres {rel:.3e} (4e: see above), iterations {res.iters} (4e: "
          f"{nd_res.iters}), max|x - x(4e)| / max|x(4e)| = {agree:.3e} (limit {X_AGREE:.0e}), "
          f"solve wallclock {seconds:.3f} s")
    if not (res.relres <= RELRES_MAX and rel <= RELRES_MAX and agree <= X_AGREE):
        fail("the sharded doublet solve is not certified or does not agree with 4e")
    return seconds, counts


def _counted(fn):
    """fn() with the launch counts set to 0 just before and read just
    after; returns (its result, seconds, counts)."""
    from tpuqcd_torch.ops import dslash_cuda
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(dslash_cuda.counts)


#: the kernels a path on a one-rank mesh launches, by policy and operator:
#: fused takes halo mode (K6, the shard's own faces), overlap the interior
#: launch alone (one rank has no repairs)
MESH_KEYS = {("fused", "tm"): ("float32:halo", "float64:halo"),
             ("overlap", "tm"): ("float32", "float64"),
             ("fused", "clover"): ("bfloat16:clover_inv:halo", "bfloat16:clover_xpay:halo",
                                   "float64:clover_inv:halo", "float64:clover_xpay:halo",
                                   "float64:halo"),
             ("overlap", "clover"): ("bfloat16:clover_inv", "bfloat16:clover_xpay",
                                     "float64:clover_inv", "float64:clover_xpay", "float64")}


def mesh_direct_path(dev, ref, clover: bool = False, dims=MID) -> dict:
    """4o: 4a's twisted-mass solve (or, with ``clover``, 4c's twisted-clover
    solve) through solve_tm_sharded on a one-rank LatticeMesh, under the
    fused and the overlap policy, at ``dims``: certified by the solver and
    by the plain float64 operator, x against the one-card twin ``ref``
    (4a's or 4c's solve at the same size) within X_AGREE, the launch counts
    of the run, no plain call.  Returns {policy: (seconds, counts)}."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import (ShardedTMCloverOperatorPC, ShardedTMOperatorPC,
                                               clover_fields_to, extend_gauge)
    from tpuqcd_torch.solve import make_clover_fields, solve_tm_sharded
    lat = Lattice(dims)
    lmesh = LatticeMesh.make(lat, 1)
    kappa, mu = (CL_KAPPA, CL_MU) if clover else (KAPPA, MU)
    ug = extend_gauge(lmesh, ref.u_pk.double())
    if clover:
        f64 = (ug, *make_clover_fields(ref.u_pk, lat, kappa=kappa, mu=mu, csw=CL_CSW))
        fields = (clover_fields_to(f64, torch.bfloat16, rows=2),
                  clover_fields_to(f64, torch.float64))
        solver = dict(solver="bicgstab", inner_tol=1e-4)
        a64 = clover_blocks_of(ref.u_pk, lat, kappa, CL_CSW).double()
    else:
        fields = (ug.to(torch.float32, rows=2), ug.to(torch.float64))
        solver, a64 = dict(solver="cg"), None
    del ug
    out = {}
    for policy in ("fused", "overlap"):
        cls = ShardedTMCloverOperatorPC if clover else ShardedTMOperatorPC
        op = cls(lat, kappa=kappa, mu=mu, lmesh=lmesh, comm_policy=policy)
        res, seconds, counts = _counted(lambda: solve_tm_sharded(
            op, *fields, ref.b_pk, tol=RELRES_MAX, **solver))
        print(f"  {policy}: launches during the run: {counts}")
        if counts.get("plain", 0) != 0:
            fail(f"the sharded solve called the plain version {counts['plain']} times")
        need_launches(counts, MESH_KEYS[(policy, "clover" if clover else "tm")])
        rel = plain_full_relres(ref.u_pk.double(), ref.b_pk.double(), res.x, lat, kappa, mu, a64)
        agree = ((res.x - ref.x).abs().max() / ref.x.abs().max()).item()
        twin = f"{'4c' if clover else '4a'}'s twin"
        print(f"  {policy}: certified relres {res.relres:.3e}, plain-operator relres {rel:.3e}, "
              f"iterations {res.iters} ({twin}: {ref.iters}), max|x - x(twin)| / max|x(twin)| "
              f"= {agree:.3e} (limit {X_AGREE:.0e}), solve wallclock {seconds:.3f} s ({twin}: "
              f"{ref.seconds:.3f} s)")
        if not (res.relres <= RELRES_MAX and rel <= RELRES_MAX and agree <= X_AGREE):
            fail(f"the sharded solve under {policy} is not certified or does not agree")
        out[policy] = (seconds, counts)
    return out


def mesh_mg_path(dev, mg_res, gauge, dims=MID):
    """4p: 4b's solve through the sharded fine level (mg/shard.ShardedFineLevel,
    the fused policy, via cli/common.MGSolver with a LatticeMesh) on a
    one-rank mesh at ``dims``, beside its one-card twin ``mg_res`` (4b's
    recipe on ``gauge``, 4b's heatbath recipe at the same size): its hops are
    halo launches with the shard's own faces, bit for bit the unsharded
    kernel's, so from the same seed the hierarchy and the solve are the
    twin's: x within X_AGREE of the twin's, certified by the solver and the
    plain float64 operator, the inner iterations equal and the seconds
    beside the twin's.  Returns (setup seconds, solve seconds, counts, the
    sharded hierarchy, the solve's result)."""
    from tpuqcd_torch.cli.common import MGSolver
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.solve import solve_tm_mg
    lat = Lattice(dims)
    cfg = mg_config(MG_KAPPA, MG_MU, dims=dims)
    solver = MGSolver(cfg, lat, gauge.u_pk, LatticeMesh.make(lat, 1), "fused")

    def run():
        t0 = time.perf_counter()
        mg = solver.setup(+1)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        return mg, setup, solve_tm_mg(mg, mg_res.b_pk, tol=RELRES_MAX, inner_tol=1e-7)
    (mg, setup, res), seconds, counts = _counted(run)
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the sharded MG called the plain version {counts['plain']} times")
    need_launches(counts, ("float32:halo", "bfloat16:halo", "float64:halo", "float32:dirs:halo"))
    rel = plain_full_relres(gauge.u_pk.double(), mg_res.b_pk.double(), res.x, lat, MG_KAPPA,
                            MG_MU)
    agree = ((res.x - mg_res.x).abs().max() / mg_res.x.abs().max()).item()
    st = mg.setup_seconds
    print(f"  MG setup {setup:.2f} s (null vectors {st['nulls0']:.2f} s, Galerkin probing "
          f"{st['galerkin0']:.2f} s; twin: {mg_res.setup_seconds['mg_setup']:.2f} s), solve "
          f"{seconds - setup:.3f} s (twin: {mg_res.seconds:.3f} s); certified relres "
          f"{res.relres:.3e}, plain-operator relres {rel:.3e}; inner iterations {res.iters} "
          f"(twin: {mg_res.iters}), refinements {res.refinements} (twin: {mg_res.refinements}); "
          f"max|x - x(twin)| / max|x(twin)| = {agree:.3e} (limit {X_AGREE:.0e})")
    if not (res.relres <= RELRES_MAX and rel <= RELRES_MAX and agree <= X_AGREE):
        fail("the sharded MG solve is not certified or does not agree with its twin")
    if res.iters != mg_res.iters:
        fail(f"the sharded MG took {res.iters} inner iterations, its twin {mg_res.iters}: on a "
             "one-rank mesh the hierarchy and the solve are the one-card run's")
    return setup, seconds - setup, counts, mg, res


def mesh_eigcg_path(dev, gauge, dims=MID):
    """4q: three columns through ShardedEigCGSolver on a one-rank mesh (4l's
    action on 4b's heatbath recipe at ``dims``, the fused policy) and
    through the one-card EigCGSolver from the same sources: every column
    certified by both and by the plain float64 operator, x within X_AGREE,
    the iterations and the space's size equal.  Returns (seconds, counts,
    one-card seconds)."""
    from tpuqcd_torch.cli.common import random_source
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.solve import EigCGSolver, ShardedEigCGSolver
    lat = Lattice(dims)
    cols = random_source(lat, dev, seed=41, columns=3)
    kw = dict(kappa=TWOP_KAPPA, mu=TWOP_MU)

    def solve_all(es):
        return [es.solve(c, tol=RELRES_MAX) for c in cols], es.space.k
    (one, k_one), one_s, _ = _counted(lambda: solve_all(EigCGSolver(gauge.u_pk, lat, **kw)))
    (shd, k_shd), seconds, counts = _counted(lambda: solve_all(
        ShardedEigCGSolver(gauge.u_pk, lat, LatticeMesh.make(lat, 1), **kw)))
    print(f"  launches during the sharded run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the sharded eigCG called the plain version {counts['plain']} times")
    need_launches(counts, ("float32:halo", "float64:halo"))
    agree = max(((a.x - b.x).abs().max() / b.x.abs().max()).item() for a, b in zip(shd, one))
    rel = max(plain_full_relres(gauge.u_pk.double(), c.double(), r.x, lat, TWOP_KAPPA, TWOP_MU)
              for c, r in zip(cols, shd))
    print(f"  sharded: iterations {[r.iters for r in shd]}, space k = {k_shd}, {seconds:.3f} s; "
          f"one card: iterations {[r.iters for r in one]}, space k = {k_one}, {one_s:.3f} s; "
          f"certified relres <= {max(r.relres for r in shd):.3e}, plain-operator relres <= "
          f"{rel:.3e}; max|x - x(one card)| / max|x| = {agree:.3e} (limit {X_AGREE:.0e})")
    if not (max(r.relres for r in shd + one) <= RELRES_MAX and rel <= RELRES_MAX
            and agree <= X_AGREE and [r.iters for r in shd] == [r.iters for r in one]
            and k_shd == k_one):
        fail("the sharded eigCG is not certified or differs from the one-card run")
    return seconds, counts, one_s


def example_config(name: str, **gauge):
    """examples/<name> with the gauge keys ``gauge`` put over its own."""
    from tpuqcd_torch.utils.config import load_config
    cfg = load_config(os.path.join(EXAMPLES, name))
    return dataclasses.replace(cfg, gauge=dataclasses.replace(cfg.gauge, **gauge))


def heatbath_gauge(dev, dims):
    """4b's heatbath recipe (beta 6.0, MG_SWEEPS compound sweeps from a cold
    start, seed 0) at ``dims``, through cli/common.setup_gauge on the card,
    its plaquette held within PLAQ_TOL of PLAQ_BETA6."""
    from tpuqcd_torch.cli.common import setup_gauge
    gauge = setup_gauge(mg_config(MG_KAPPA, MG_MU, dims=dims), dev)
    print(f"  heatbath gauge {'x'.join(map(str, dims))}: {MG_SWEEPS} compound sweeps "
          f"{gauge.seconds:.3f} s, plaquette {gauge.plaquette:.6f}", flush=True)
    if abs(gauge.plaquette - PLAQ_BETA6) > PLAQ_TOL:
        fail(f"plaquette {gauge.plaquette:.6f} is not within {PLAQ_TOL} of {PLAQ_BETA6}")
    return gauge


def musweep_path(dev, gauge, chain):
    """4r: run_invert's mass sweep (examples/invert_musweep_32cube.yaml:
    one multishift CG space to solver.inner_tol, then every mass certified
    to 1e-10 from its x_i) on 4b's gauge c0000, the file of the chain: every
    mass certified by the solver and by the plain float64 operator; the
    multishift iterations, the stage's residual and each mass's refinement
    iterations, the seconds, the peak memory; then the same masses solved
    cold by solve_tm one by one, certified the same way, their iterations
    and seconds beside the sweep's.  Returns (result, counts, cold counts,
    cold results)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.solve import solve_tm
    cfg = example_config("invert_musweep_32cube.yaml", heatbath_beta=None,
                         config_file=chain["files"][0], plaquette_check=chain["plaquettes"][0])
    a, sv, lat = cfg.action, cfg.solver, Lattice(LARGE)
    torch.cuda.reset_peak_memory_stats(dev)
    res, counts = counted_invert(cfg, dev, gauge)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    need_launches(counts, ("float32", "float64"))
    sw = res.sweep
    u64, b64 = res.u_pk.double(), res.b_pk.double()
    plain = [plain_full_relres(u64, b64, x, lat, a.kappa, mu) for x, mu in zip(sw.xs, sw.mu_list)]
    for i, mu in enumerate(sw.mu_list):
        print(f"  mu {mu:g}: multishift stage relres {sw.multishift_relres[i]:.3e}; certified "
              f"{sw.solver_relres[i]:.3e} (solver), {sw.relres[i]:.3e} (full system), "
              f"{plain[i]:.3e} (plain operator) after {sw.refine_iters[i]} sloppy matvecs in "
              f"{sw.refinements[i]} refinements")
    print(f"  {len(sw.mu_list)} masses from one Krylov space: {sw.multishift_iters} multishift "
          f"iterations {sw.seconds['multishift']:.3f} s, certification "
          f"{sw.seconds['refinement']:.3f} s ({sum(sw.refine_iters)} sloppy matvecs), total "
          f"{sw.seconds['total']:.3f} s; peak memory {peak:.2f} GiB")
    if not (max(plain) <= RELRES_MAX and max(sw.relres) <= RELRES_MAX
            and max(sw.solver_relres) <= RELRES_MAX):
        fail("a mass of the sweep is not certified")
    del sw
    res = dataclasses.replace(res, x=None, sweep=None)
    cold, cold_counts, cold_s = [], {}, 0.0
    for mu in a.mu_list:
        r, secs, c = _counted(lambda: solve_tm(gauge.u_pk, res.b_pk, lat, kappa=a.kappa, mu=mu,
                                               tol=sv.tol, maxiter=sv.maxiter,
                                               inner_tol=sv.inner_tol))
        rel = plain_full_relres(u64, b64, r.x, lat, a.kappa, mu)
        print(f"  cold solve_tm mu {mu:g}: {r.iters} sloppy matvecs, {r.refinements} "
              f"refinements, {secs:.3f} s; certified relres {r.relres:.3e}, plain-operator "
              f"relres {rel:.3e}")
        if not (r.relres <= RELRES_MAX and rel <= RELRES_MAX):
            fail(f"the cold solve at mu {mu:g} is not certified")
        if c.get("plain", 0) != 0:
            fail("the cold solves called the plain version")
        for k, v in c.items():
            cold_counts[k] = cold_counts.get(k, 0) + v
        cold.append((r.iters, r.refinements, secs))
        cold_s += secs
        del r
    print(f"  four cold solves: {sum(c[0] for c in cold)} sloppy matvecs, {cold_s:.3f} s; the "
          f"sweep: {res.iters} multishift iterations (4 hops each) and "
          f"{res.refinements} refinements, {res.seconds:.3f} s")
    return res, counts, cold_counts, cold


def musweep_mesh_path(dev, gauge):
    """4r on a one-rank mesh: the sweep of examples/invert_musweep_32cube.yaml
    through solve_tm_musweep and certify_musweep on a one-rank LatticeMesh
    (mg/shard.ShardedFineLevel, the fused policy; solve_tm_sharded) at MID,
    beside the same two calls on one card: the x_i of the stage and of the
    certification bit for bit, the same iterations, every mass certified
    by the plain float64 operator.  Returns (seconds, one-card seconds,
    counts)."""
    from tpuqcd_torch.cli.common import random_source
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.solve import certify_musweep, solve_tm_musweep
    cfg = example_config("invert_musweep_32cube.yaml")
    a, sv, lat = cfg.action, cfg.solver, Lattice(MID)
    b = random_source(lat, dev)
    kw = dict(kappa=a.kappa, mu_list=a.mu_list)

    def run(lmesh):
        xs, rel, iters = solve_tm_musweep(gauge.u_pk, b, lat, tol=sv.inner_tol,
                                          maxiter=sv.maxiter, lmesh=lmesh, **kw)
        certs = certify_musweep(gauge.u_pk, b, lat, xs, tol=sv.tol, maxiter=sv.maxiter,
                                inner_tol=sv.inner_tol, lmesh=lmesh, **kw)
        return xs, rel, iters, certs
    (xs1, rel1, it1, c1), one_s, one_counts = _counted(lambda: run(None))
    (xsm, relm, itm, cm), mesh_s, counts = _counted(lambda: run(LatticeMesh.make(lat, 1)))
    print(f"  launches on the one-rank mesh: {counts}")
    if counts.get("plain", 0) != 0 or one_counts.get("plain", 0) != 0:
        fail("the sweep called the plain version")
    need_launches(one_counts, ("float32", "float64"))
    need_launches(counts, ("float32:halo", "float64:halo"))
    u64, b64 = gauge.u_pk.double(), b.double()
    plain = [plain_full_relres(u64, b64, c.x, lat, a.kappa, mu) for c, mu in zip(cm, a.mu_list)]
    same = (torch.equal(xs1, xsm) and it1 == itm
            and all(torch.equal(p.x, q.x) and p.iters == q.iters for p, q in zip(c1, cm)))
    print(f"  one-rank mesh: {itm} multishift iterations (one card {it1}), stage relres "
          + ", ".join(f"{r:.3e}" for r in relm) + " (one card "
          + ", ".join(f"{r:.3e}" for r in rel1) + "); refinement matvecs "
          f"{[c.iters for c in cm]} (one card {[c.iters for c in c1]}); certified "
          f"<= {max(c.relres for c in cm):.3e}, plain-operator <= {max(plain):.3e}; x_i and "
          f"counts bit for bit the one card's: {same}; {mesh_s:.3f} s (one card {one_s:.3f} s)")
    if not (max(c.relres for c in cm + c1) <= RELRES_MAX and max(plain) <= RELRES_MAX):
        fail("a mass of the sweep on the one-rank mesh is not certified")
    if not same:
        fail("the sweep on a one-rank mesh differs from the one-card sweep")
    return mesh_s, one_s, counts


def mesh_threep_path(dev, gauge, dims=MID):
    """4t: run_threeptwop.measure (its two-point stages included) on a
    one-rank LatticeMesh at ``dims`` on 4p's gauge, beside its one-card twin
    (the same call without the mesh): 4j's action, solver and smearing, the
    P5z projector, the proton, the source at MESH_SRC off the origin and
    t_sink MESH_T_SINK.  Every column of both runs certified by the solver
    (on the mesh by the sharded float64 operator) and by the plain float64
    operator (audited_measure); every dataset of the mesh run within
    MESH_RUN_AGREE of the twin's largest value; the mesh run launching K6
    (halo mode, the shard's own faces), no batch and no plain call.
    Returns (mesh counts, mesh stages, twin stages, mesh seconds, twin
    seconds)."""
    from tpuqcd_torch.cli import run_threeptwop
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    lat, u64 = Lattice(dims), gauge.u_pk.double()
    cfg = twop_config("unused.h5", gauge={"dims": list(dims)}, projectors=["P5z"],
                      baryons=["proton"], t_sinks=[MESH_T_SINK], sink_momentum=[0, 0, 0],
                      source_positions=[list(MESH_SRC)])
    runs = {}
    for name, kw in (("one card", {}), ("one-rank mesh", {"lmesh": LatticeMesh.make(lat, 1)})):
        t0 = time.perf_counter()
        res, counts, audited, audit_s, peak = audited_measure(run_threeptwop.measure, cfg, dev,
                                                              gauge, u64, lat, **kw)
        seconds = time.perf_counter() - t0
        check_columns(res, audited, 24 + 24, f"{name}: the 24 forward and 24 backward columns")
        print(f"  {name}: {seconds:.3f} s (the plain-operator audit {audit_s:.3f} s), peak "
              f"memory {peak:.2f} GiB; seconds by stage: "
              + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items()), flush=True)
        runs[name] = (res, counts, seconds)
    (one, _, one_s), (mesh, counts, mesh_s) = runs["one card"], runs["one-rank mesh"]
    need_launches(counts, ("float32:halo", "float64:halo"))
    if any(v for k, v in counts.items() if k.endswith(":batch")):
        fail(f"the mesh run launched the batched kernel: {counts}")
    if not all(len(r["relres"]) == 1 for r in mesh.solves):
        fail("the mesh run did not solve its columns one at a time")

    def datasets(res):
        out = dict(res.twop)
        out.update({f"{g}/{k}": v for g, ins in res.threep.items() for k, v in ins.items()})
        return out
    got, want = datasets(mesh), datasets(one)
    if sorted(got) != sorted(want) or len(want) != 1 + 2 * 32:
        fail(f"the mesh run's datasets {len(got)}, the twin's {len(want)}, not {1 + 2 * 32}")
    worst = max(np.abs(got[k] - w).max() / np.abs(w).max() for k, w in want.items())
    finite = all(np.isfinite(v).all() and v.shape == (2, dims[3]) for v in got.values())
    print(f"  {len(want)} datasets: max over datasets of max|mesh - twin| / max|twin| "
          f"{worst:.3e} (limit {MESH_RUN_AGREE:.0e}); finite, shape (2, {dims[3]}): {finite}")
    if not (worst <= MESH_RUN_AGREE and finite):
        fail("the three-point run on the one-rank mesh differs from its one-card twin")
    return counts, mesh.seconds, one.seconds, mesh_s, one_s


def mesh_loops_path(dev, gauge, dims=MID):
    """4u: run_loops.measure on a one-rank LatticeMesh at ``dims`` on 4p's
    gauge, beside its one-card twin (the same call without the mesh): 4k's
    physics (one Z4 noise in 12 spin-colour classes, TSM with 4 cheap
    noises, 8 Lanczos modes written to eig_outfile, the 33 momenta of q^2
    <= 4, the one-derivative loops) at 4o's action (KAPPA, MU, CG).  Every
    full and low-mode column of both runs certified by the solver and by
    the plain float64 operator; the mesh basis orthonormal with positive
    ascending Rayleigh quotients and its eig_outfile read back bit for bit;
    every dataset of the mesh run within MESH_RUN_AGREE of the twin's
    largest value; the mesh run launching K6 (halo mode), no batch and no
    plain call.  Returns (mesh counts, mesh stages, twin stages, mesh
    seconds, twin seconds)."""
    from tpuqcd_torch.cli import run_loops
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.utils.checkpoint import load_eigenpairs
    lat, u64, n_def = Lattice(dims), gauge.u_pk.double(), LOOPS_N_DEFLATE
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in (("one card", {}), ("one-rank mesh", {"lmesh": LatticeMesh.make(lat, 1)})):
            eig = os.path.join(tmp, f"eig{len(runs)}.npz")
            cfg = loops_config(os.path.join(tmp, "unused.h5"), dims, KAPPA, MU, eig_outfile=eig)
            t0 = time.perf_counter()
            res, counts, audited, audit_s, peak = audited_measure(
                run_loops.measure, cfg, dev, gauge, u64, lat, keep_fields=True, **kw)
            seconds = time.perf_counter() - t0
            check_columns(res, audited, 12 + n_def, f"{name}: the noise's 12 classes and "
                          f"{n_def} low modes")
            print(f"  {name}: {seconds:.3f} s (the plain-operator audit {audit_s:.3f} s), peak "
                  f"memory {peak:.2f} GiB; seconds by stage: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items()), flush=True)
            evals, evecs = load_eigenpairs(eig, expect_layout="packed", n_expect=n_def)
            same = (np.array_equal(evals, res.evals)
                    and torch.equal(torch.stack(evecs), res.evecs.cpu()))
            runs[name] = (res, counts, seconds, same)
    (one, _, one_s, _), (mesh, counts, mesh_s, same) = runs["one card"], runs["one-rank mesh"]
    need_launches(counts, ("float32:halo", "float64:halo"))
    if any(v for k, v in counts.items() if k.endswith(":batch")):
        fail(f"the mesh run launched the batched kernel: {counts}")
    if not all(len(r["relres"]) == 1 for r in mesh.solves):
        fail("the mesh run did not solve its columns one at a time")
    v = mesh.evecs.reshape(n_def, 2, -1).double()
    vc = torch.complex(v[:, 0], v[:, 1])
    gram = (vc.conj() @ vc.T - torch.eye(n_def, device=dev)).abs().max().item()
    print(f"  mesh basis: |V^dag V - 1|_max {gram:.2e} (limit {BASIS_TOL:.0e}); Rayleigh "
          f"quotients {', '.join(f'{e:.5e}' for e in mesh.evals)} (twin's: "
          f"{', '.join(f'{e:.5e}' for e in one.evals)}); eig_outfile read back "
          f"{'equal' if same else 'NOT equal'} to the basis in memory bit for bit")
    if not (gram <= BASIS_TOL and (mesh.evals > 0).all() and (np.diff(mesh.evals) >= 0).all()):
        fail("the mesh run's Lanczos basis is not orthonormal, or its Rayleigh quotients are "
             "not positive and ascending")
    if not same:
        fail("the mesh run's saved eigenpairs differ from its basis in memory")
    groups = ["loops/oneend", "loops/oneend_der", "loops/oneend_lowmode",
              "loops/oneend_lowmode_der"]
    if sorted(mesh.loops) != sorted(one.loops) or sorted(one.loops) != groups:
        fail(f"the mesh run's datasets {sorted(mesh.loops)}, the twin's {sorted(one.loops)}")
    worst, finite, n = 0.0, True, 0
    for group, loops in one.loops.items():
        for ins, w in loops.items():
            got = mesh.loops[group][ins]
            worst = max(worst, np.abs(got - w).max() / np.abs(w).max())
            finite &= bool(np.isfinite(got).all() and got.shape == w.shape == (33, dims[3]))
            n += 1
    print(f"  {n} datasets: max over datasets of max|mesh - twin| / max|twin| {worst:.3e} "
          f"(limit {MESH_RUN_AGREE:.0e}); finite, shape (33, {dims[3]}): {finite}")
    if not (n == 2 * (16 + 64) and worst <= MESH_RUN_AGREE and finite):
        fail("the loop run on the one-rank mesh differs from its one-card twin")
    return counts, mesh.seconds, one.seconds, mesh_s, one_s


def mg3_path(dev):
    """4s: BASELINE config 3, the three-level hierarchy of
    examples/invert_mg3_24cube.yaml at 24^3x48 on 4b's heatbath recipe at
    that size, through run_invert; then 4b's two-level recipe on the same
    gauge.  Each: the setup seconds by level, the solve seconds, the inner
    iterations and refinements, the coarsest level's dims, certified by the
    solver and by the plain float64 operator.  Returns ((three-level result,
    counts), (two-level result, counts), heatbath seconds)."""
    from tpuqcd_torch.lattice import Lattice
    cfg = example_config("invert_mg3_24cube.yaml")
    if tuple(cfg.gauge.dims) != MG3_DIMS or len(cfg.mg.n_vec) != 2:
        fail(f"examples/invert_mg3_24cube.yaml is not a three-level {MG3_DIMS} run")
    gauge = heatbath_gauge(dev, MG3_DIMS)
    lat = Lattice(MG3_DIMS)
    out = []
    for what, run in (("three-level", lambda: counted_invert(cfg, dev, gauge, dims=MG3_DIMS)),
                      ("two-level (4b's recipe)", lambda: mg_path(dev, gauge, dims=MG3_DIMS))):
        print(f"  {what}:")
        res, counts = run()
        if what == "three-level":
            need_launches(counts, ("float32", "bfloat16", "float64", "float32:legs_out"))
            check_plain(res, lat, cfg.action.kappa, cfg.action.mu)
        st, coarse = res.setup_seconds, res.mg.levels[1:]
        stages = [f"{k}{d} {st[f'{k}{d}']:.2f} s" for d in range(len(coarse))
                  for k in ("nulls", "galerkin")]
        print(f"  {what}: coarse levels (T, Z, Y, X) {[lv.dims for lv in coarse]}, the coarsest "
              f"{coarse[-1].dims} with {coarse[-1].n} dofs a site; setup {st['mg_setup']:.2f} s: "
              + ", ".join(stages) + f"; solve {res.seconds:.3f} s, {res.iters} inner "
              f"iterations, {res.refinements} refinements")
        out.append((slim(res), counts))
    (r3, _), (r2, _) = out
    print(f"  three-level against two-level on the same gauge: setup "
          f"{r3.setup_seconds['mg_setup']:.2f} / {r2.setup_seconds['mg_setup']:.2f} s, solve "
          f"{r3.seconds:.3f} / {r2.seconds:.3f} s, inner iterations {r3.iters} / {r2.iters}")
    return out[0], out[1], gauge.seconds


def invert_rank(argv) -> None:
    """One rank of phase 4g under torchrun: run_invert's entry (parse_args,
    which joins the process group, then invert); rank 0 saves the gathered
    x to the path after --save-x.

        torchrun --nproc_per_node 2 chip_smoke.py --invert-rank \\
            --config cfg.yaml --save-x x.pt [--device cpu]
    """
    from tpuqcd_torch.cli import run_invert
    from tpuqcd_torch.cli.common import parse_args
    from tpuqcd_torch.parallel import dist as tdist
    i = argv.index("--save-x")
    cfg, device = parse_args(run_invert.__doc__, argv[:i] + argv[i + 2:])
    try:
        res = run_invert.invert(cfg, device)
        if res.x is not None:
            torch.save(res.x.cpu(), argv[i + 1])
    finally:
        tdist.shutdown()


def torchrun_invert(n: int, cfg: dict, extra=()) -> tuple[str, torch.Tensor, str]:
    """run_invert of the config ``cfg`` (a dict) under torchrun on n ranks
    (chip_smoke.py --invert-rank; ``extra``: more arguments, --device cpu
    for a rehearsal over gloo); returns (rank 0's RESULT line, its gathered
    x on the CPU, the ranks' output)."""
    import yaml
    with tempfile.TemporaryDirectory() as tmp:
        path, x_path = os.path.join(tmp, "mesh.yaml"), os.path.join(tmp, "x.pt")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)      # writes 1e-10 as 1.0e-10, a YAML float
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc_per_node", str(n), os.path.abspath(__file__),
                            "--invert-rank", "--config", path, "--save-x", x_path, *extra],
                           capture_output=True, text=True, timeout=600,
                           env={**os.environ, "TPUQCD_RESOURCE_PATH": tmp})
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode != 0 or len(line) != 1 or not os.path.exists(x_path):
            fail(f"torchrun of {n} ranks: rc {r.returncode}\n{r.stdout[-2000:]}\n"
                 f"{r.stderr[-2000:]}")
        return line[0], torch.load(x_path), r.stdout + r.stderr


def _chain_rank_gauge() -> dict:
    return {"dims": list(LARGE), "heatbath_beta": MG_BETA, "random_seed": 0,
            "heatbath_sweeps": CHAIN_RANK_SWEEPS, "heatbath_n_cfg": CHAIN_RANK_MEMBERS,
            "heatbath_skip": CHAIN_RANK_SKIP}


def torchrun_chain_start(ens_dir: str) -> dict:
    """4x, first half: run_invert's main as one rank under torchrun over NCCL
    (a process group of one: parallel/dist.init_distributed) on a heatbath
    chain of CHAIN_RANK_MEMBERS members at 32^3x64 (CHAIN_RANK_SWEEPS sweeps
    to the first, CHAIN_RANK_SKIP between), 4a's action, started beside
    phase 3 (whose checks are not timed): the rank generates the chain,
    writes each member behind one all-reduce (cli/common.
    _heatbath_chain_members), then solves on each member read back.  A
    thread reads its output and notes when it ended."""
    import threading

    import yaml
    rank_dir = os.path.join(ens_dir, "rank_chain")
    cfg_path = os.path.join(ens_dir, "chain_rank.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"action": {"kappa": KAPPA, "mu": MU},
                        "solver": {"solver": "cg", "tol": RELRES_MAX},
                        "gauge": {**_chain_rank_gauge(), "heatbath_dir": rank_dir},
                        "physics": {"output": os.path.join(ens_dir, "chain_rank.h5")}}, f)
    torch.cuda.empty_cache()
    run = {"dir": rank_dir, "t0": time.perf_counter()}
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "tpuqcd_torch.cli.run_invert", "--config", cfg_path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))

    def read():
        run["text"] = run["proc"].communicate()[0]
        run["seconds"] = time.perf_counter() - run["t0"]
    run["reader"] = threading.Thread(target=read, name="4x", daemon=True)
    run["reader"].start()
    atexit.register(lambda: run["proc"].poll() is None and run["proc"].kill())
    return run


def torchrun_chain_finish(dev, ens_dir: str, run: dict) -> dict:
    """4x, second half: the same chain generated and written in this process
    (no group), then the rank's result.  Checks: the launch's exit code,
    its NCCL group, one certified RESULT line a member, and its member files
    byte for byte this process's.  Returns the seconds and this process's
    writes."""
    import filecmp

    from tpuqcd_torch.cli.common import _heatbath_chain_members
    from tpuqcd_torch.utils.config import config_from_dict
    from torch.distributed import constants
    here_dir = os.path.join(ens_dir, "local_chain")
    t0 = time.perf_counter()
    keep = []
    here = _heatbath_chain_members(config_from_dict(
        {"action": {"kappa": KAPPA, "mu": MU},
         "gauge": {**_chain_rank_gauge(), "heatbath_dir": here_dir}}), dev, keep)
    t_here = time.perf_counter() - t0
    run["reader"].join(timeout=600)
    proc, text = run["proc"], run.get("text", "")
    if run["reader"].is_alive():
        proc.kill()
        fail("the torchrun launch of 4x did not end within 600 s of the chain here")
    results = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    nccl = re.search(r"distributed: rank 0/1 \(nccl\)", text)
    if proc.returncode != 0 or len(results) != CHAIN_RANK_MEMBERS or nccl is None:
        fail(f"torchrun of run_invert on a heatbath chain: rc {proc.returncode}, "
             f"{len(results)} RESULT lines, NCCL group {'formed' if nccl else 'missing'}\n"
             f"{text[-3000:]}")
    rels = [float(re.search(r"relres=(\S+)", ln).group(1)) for ln in results]
    files = [os.path.basename(g.config_file) for _, g in here]
    same = [filecmp.cmp(os.path.join(run["dir"], name), os.path.join(here_dir, name),
                        shallow=False) for name in files]
    waits = re.findall(r"heatbath chain member (\d+) .*write (\S+) s", text)
    print(f"  one rank over NCCL (torch.distributed default timeout "
          f"{getattr(constants, 'default_pg_nccl_timeout', constants.default_pg_timeout)}): "
          f"{CHAIN_RANK_MEMBERS} members, certified relres {', '.join(f'{r:.3e}' for r in rels)}; "
          f"the rank's writes {', '.join(f'{w} s' for _, w in waits)}; its launch "
          f"{run['seconds']:.2f} s, beside phase 3; the chain in this process {t_here:.2f} s "
          "(writes " + ", ".join(f"{sum(k['write'].values()):.3f} s" for k in keep) + ")")
    print(f"  member files byte for byte the same chain generated here: "
          f"{', '.join(f'{n} {s}' for n, s in zip(files, same))}")
    if not (all(same) and max(rels) <= RELRES_MAX):
        fail("the chain under torchrun is not this process's chain, or a member's solve is "
             "not certified")
    shutil.rmtree(run["dir"], True)
    shutil.rmtree(here_dir, True)
    return {"rank": run["seconds"], "here": t_here, "writes": [k["write"] for k in keep]}


def multi_card_path(nd_x, tm_x, mg_x, mg_gauge: dict) -> None:
    """4g: run_invert under torchrun on a mesh nt = n over NCCL, n the
    largest of 2 or 4 that the visible cards hold: the doublet (4e's
    config), twisted mass under the fused and under the overlap policy
    (4a's), twisted mass under auto (the policies timed, tune_comm_policy's
    cache in the call's temporary directory), and MG (4b's, its gauge read
    from c0000's file ``mg_gauge``);
    each x (on the CPU) held against the one-card cell's."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"  phase 4g not run: torch.cuda.device_count() = {n_cards}; the multi-rank "
              "NCCL exchange needs one process per card (it is held on the CPU over gloo by "
              "tests/test_torch_sharded.py, test_torch_sharded_clover.py, "
              "test_torch_mg_mesh.py, test_torch_mg_mesh_y.py, test_torch_eigcg_mesh.py, "
              "test_torch_invert_mesh.py; the policy tuner by test_torch_tune.py)")
        return
    n = 4 if n_cards >= 4 else 2
    tm = {"gauge": {"dims": list(LARGE), "random_seed": 1},
          "action": {"kappa": KAPPA, "mu": MU},
          "solver": {"solver": "cg", "tol": RELRES_MAX}, "mesh": {"nt": n}}
    mg = {"gauge": mg_gauge, "action": {"kappa": MG_KAPPA, "mu": MG_MU},
          "solver": {"tol": RELRES_MAX, "inner_tol": 1e-7, "comm_policy": "fused"},
          "mg": {"enabled": True, "preset": "near_critical"}, "mesh": {"nt": n}}
    runs = [("doublet (4e)", ndeg_dict(n), nd_x, "ndeg solve"),
            ("twisted mass, fused (4a)", {**tm, "solver": {**tm["solver"],
                                                           "comm_policy": "fused"}}, tm_x,
             "sharded solve"),
            ("twisted mass, overlap (4a)", {**tm, "solver": {**tm["solver"],
                                                             "comm_policy": "overlap"}}, tm_x,
             "sharded solve"),
            ("twisted mass, auto (4a; the policy timed on the cards)", tm, tm_x,
             "sharded solve"),
            ("MG (4b)", mg, mg_x, "mg solve")]
    for what, cfg, ref, tag in runs:
        line, x, log_text = torchrun_invert(n, cfg)
        iters = re.findall(tag + r": .* iters=(\d+)", log_text)
        rel = float(re.search(r"relres=(\S+)", line).group(1))
        agree = ((x - ref).abs().max() / ref.abs().max()).item()
        print(f"  {what}, {n} ranks over NCCL: {line}; iterations {iters[0] if iters else '?'}; "
              f"max|x - x(one card)| / max|x| = {agree:.3e} (limit {X_AGREE:.0e})")
        if not (rel <= RELRES_MAX and agree <= X_AGREE):
            fail(f"the {n}-rank {what} solve: relres {rel:.3e}, x against one card's {agree:.3e}")
        if "auto" in what:
            tuned = re.search(r"comm_policy timed .* -> (\w+)", log_text)
            if tuned is None:
                fail(f"the {n}-rank {what} solve did not time the policies")
            print(f"  comm_policy auto took {tuned.group(1)} (utils/tune.tune_comm_policy)")


def per_leg_probing(mg_res):
    """4b's coarse operator built once more by per-leg probing (one dirs
    launch per leg and parity, the memory-lean switch of
    mg/device.build_coarse_device), held against the fused probing;
    returns the launch counts of the per-leg build."""
    from tpuqcd_torch.mg.device import build_coarse_device
    from tpuqcd_torch.ops import dslash_cuda
    level, tr = mg_res.mg.levels[0], mg_res.mg.transfers[0]
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    per_leg = build_coarse_device(level, tr, fused_legs=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(dslash_cuda.counts)
    print(f"  per-leg probing {seconds:.2f} s, launches: {counts}")
    if counts.get("plain", 0) != 0:
        fail("per-leg probing called the plain version")
    need_launches(counts, ("float32:dirs",))
    fused = build_coarse_device(level, tr, fused_legs=True).links_c
    rel = ((per_leg.links_c - fused).abs().max() / fused.abs().max()).item()
    print(f"  per-leg against fused Galerkin links: max rel err {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        fail(f"per-leg probing disagrees with the fused probing: {rel:.3e}")
    return counts


def mg_config(kappa, mu, csw=0.0, dims=LARGE):
    from tpuqcd_torch.utils.config import config_from_dict
    return config_from_dict({
        "gauge": {"dims": list(dims), "heatbath_beta": MG_BETA,
                  "heatbath_sweeps": MG_SWEEPS, "random_seed": 0},
        "action": {"kappa": kappa, "mu": mu, "csw": csw},
        "solver": {"tol": RELRES_MAX, "inner_tol": 1e-7},
        "mg": {"enabled": True, "preset": "near_critical"}})


def mg_path(dev, gauge, clover: bool = False, dims=LARGE):
    """run_invert's multigrid path on the 32^3x64 heatbath gauge: twisted
    mass (4b) or, with ``clover``, twisted clover (4d); with ``dims`` 4b's
    recipe on the heatbath gauge of that size (4p's twin, 4s's two-level
    run)."""
    from tpuqcd_torch.lattice import Lattice
    kappa, mu, csw = (MGC_KAPPA, MGC_MU, MGC_CSW) if clover else (MG_KAPPA, MG_MU, 0.0)
    res, counts = counted_invert(mg_config(kappa, mu, csw, dims), dev, gauge, dims=dims)
    st = res.setup_seconds
    rest = st["mg_setup"] - st["nulls0"] - st["galerkin0"]
    print(f"  MG setup {st['mg_setup']:.2f} s: null vectors {st['nulls0']:.2f} s, "
          f"Galerkin probing {st['galerkin0']:.2f} s, the rest (fine level"
          f"{', clover term' if clover else ''}, transfers) {rest:.2f} s")
    if clover:
        need_launches(counts, ("float32:clover_xpay", "bfloat16:clover_xpay",
                               "float64:clover_xpay", "float32:legs_out"))
    else:
        need_launches(counts, ("float32", "bfloat16", "float64", "float32:legs_out"))
    check_plain(res, Lattice(dims), kappa, mu, csw)
    return res, counts


def twop_config(output: str, gauge: dict | None = None, **physics):
    """4h's configuration; ``gauge`` keys replace its gauge block's (the
    4b heatbath; 4m and 4n), ``physics`` keys its physics block's (4j)."""
    from tpuqcd_torch.utils.config import config_from_dict
    return config_from_dict({
        "gauge": {"dims": list(LARGE), **(gauge or {"heatbath_beta": MG_BETA,
                                                    "heatbath_sweeps": MG_SWEEPS,
                                                    "random_seed": 0})},
        "action": {"kappa": TWOP_KAPPA, "mu": TWOP_MU},
        "solver": {"solver": "cg", "sloppy_dtype": "float32", "rhs_batch": 12,
                   "tol": RELRES_MAX},
        "physics": {"source_positions": [[0, 0, 0, 0]], "momenta": [[0, 0, 0], [1, 0, 0]],
                    "smear_alpha_ape": 0.5, "smear_n_ape": 5, "smear_alpha_gauss": 4.0,
                    "smear_n_gauss": 20, "projectors": ["P+"], "meson_channels": ["pion"],
                    "output": output, **physics}})


def io_line(what: str, st: dict) -> str:
    return what + ": " + ", ".join(f"{k} {st[k]:.3f} s" for k in
                                   ("take", "read", "checksum", "decode", "encode", "write")
                                   if k in st)


def chain_gauge(dev, ens_dir: str):
    """4b's gauge: cli/common._heatbath_chain_members at beta 6.0 (MG_SWEEPS
    to thermalize, then CHAIN_SKIP sweeps to the second member, seed 0),
    both members written as ILDG files into ``ens_dir``; then member c0000
    read back through gauge.config_file with its plaquette pinned, as every
    later cell uses it.  Checks: the read-back links equal the chain's in
    memory bit for bit, the checksum verified, both plaquettes within
    PLAQ_TOL of PLAQ_BETA6 and apart.  Returns (Gauge, {"files", "plaquettes",
    "sweeps", "writes", "read"})."""
    from tpuqcd_torch.cli.common import _heatbath_chain_members, setup_gauge
    from tpuqcd_torch.fields import apply_boundary_phase
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.packed import pack_gauge
    lat = Lattice(LARGE)
    cfg = twop_config(os.path.join(ens_dir, "twop.h5"), gauge={
        "heatbath_beta": MG_BETA, "heatbath_sweeps": MG_SWEEPS, "random_seed": 0,
        "heatbath_n_cfg": 2, "heatbath_skip": CHAIN_SKIP, "heatbath_dir": ens_dir})
    keep = []
    members = _heatbath_chain_members(cfg, dev, keep)
    for (ctag, g), k in zip(members, keep):
        print(f"  {ctag}: {MG_SWEEPS if ctag == 'c0000' else CHAIN_SKIP} compound sweeps "
              f"{k['sweeps_seconds']:.3f} s, plaquette {k['plaquette']:.6f} (|p - {PLAQ_BETA6}| "
              f"= {abs(k['plaquette'] - PLAQ_BETA6):.2e}, limit {PLAQ_TOL}); "
              + io_line(f"written to {os.path.basename(g.config_file)}", k["write"]), flush=True)
        if abs(k["plaquette"] - PLAQ_BETA6) > PLAQ_TOL:
            fail(f"{ctag}: plaquette {k['plaquette']:.6f} is not within {PLAQ_TOL} of "
                 f"{PLAQ_BETA6}")
    if keep[0]["plaquette"] == keep[1]["plaquette"]:
        fail("the chain's two members have the same plaquette")
    detail = {}
    gauge = setup_gauge(dataclasses.replace(cfg, gauge=members[0][1]), dev, detail)
    want = pack_gauge(apply_boundary_phase(keep[0]["links"], lat, "device", True),
                      torch.float32)
    if not torch.equal(gauge.u_pk, want):
        fail("c0000 read back from its ILDG file differs from the chain's links")
    if detail["scidac_checksum"] is None:
        fail("c0000 was read without a verified scidac checksum")
    print(f"  c0000 read back through gauge.config_file: the links equal the chain's bit for "
          f"bit, scidac checksum {detail['scidac_checksum'][0]:08x} "
          f"{detail['scidac_checksum'][1]:08x} verified, plaquette pinned; "
          + io_line("read", detail) + "; the same gauge serves 4b-4n", flush=True)
    return gauge, {"files": [g.config_file for _, g in members],
                   "plaquettes": [k["plaquette"] for k in keep],
                   "sweeps": [k["sweeps_seconds"] for k in keep],
                   "writes": [k["write"] for k in keep], "read": detail}


def check_twop(res, counts, cfg, have_h5py: bool) -> None:
    """4h's checks of a two-point result (member c0000 of 4m): the launches,
    every column certified by the solver and one per solver call by the plain
    operator, the correlators finite, the pion real, positive and the
    timeslice sum of |S_u|^2, the baryon densities the unfactored Wick sum;
    where h5py imports, the file written and read back."""
    from tpuqcd_torch.cli import run_twop
    from tpuqcd_torch.gammas import PROJECTORS
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.phys.contract_dev import proton_2pt_site_dev
    lat = Lattice(LARGE)
    print(f"  launches during the run: {counts}")
    need_launches(counts, ("float32:batch", "float64:batch", "float32", "float64"))
    # every column certified by the solver, one per call by the plain operator
    tag = run_twop.source_tag((0, 0, 0, 0))
    u64, b = res.u_pk.double(), res.fields[tag]["b"]
    n_cols = 0
    for rec in res.solves:
        n_cols += rec["columns"]
        worst = max(rec["relres"])
        rel = plain_full_relres(u64, b[rec["first_column"]].double(), rec["x_first"], lat,
                                TWOP_KAPPA, TWOP_MU * rec["flavor"])
        gate = (f", batch gate {'re-chunked' if rec['gate_rechunked'] else 'kept the batch'}"
                if "gate_rechunked" in rec else "")
        print(f"  flavor {rec['flavor']:+d} columns {rec['first_column']}-"
              f"{rec['first_column'] + rec['columns'] - 1}: certified relres <= {worst:.3e}, "
              f"matvecs {min(rec['iters'])}-{max(rec['iters'])}; column "
              f"{rec['first_column']} plain-operator relres {rel:.3e}{gate}")
        if not (worst <= RELRES_MAX and rel <= RELRES_MAX):
            fail(f"a two-point column is not certified: solver {worst:.3e}, plain {rel:.3e}")
    if n_cols != 24:
        fail(f"{n_cols} columns solved, not 24")
    # the correlators
    T = LARGE[3]
    for group, corr in res.correlators.items():
        ok = corr.shape == (2, T) and bool(torch.isfinite(torch.from_numpy(corr)).all())
        if not ok:
            fail(f"{group}: shape {corr.shape} or non-finite values")
    pion = res.correlators[f"twop/pion/{tag}"][0]
    print(f"  pion p=0: C(0) {pion[0].real:.6e}, C(T/2) {pion[T // 2].real:.6e}, min Re "
          f"{pion.real.min():.3e}, max |Im| / |Re| {abs(pion.imag / pion.real).max():.2e}")
    if not (pion.real.min() > 0 and abs(pion.imag / pion.real).max() < 1e-6):
        fail("the pion correlator at p = 0 is not real and positive on every timeslice")
    f = res.fields[tag]
    # the pion by another formula: -Tr[g5 S g5 g5 S^dag g5] = sum |S|^2
    own = f["u"].double().square().sum((0, 1, 2, 3, 4, 5, 7, 8)).cpu().numpy()
    dev_pi = abs(pion.real - own).max() / own.max()
    print(f"  pion p=0 against the sum of |S_u|^2 over each timeslice: max rel diff "
          f"{dev_pi:.2e} (limit 1e-5)")
    if not dev_pi <= 1e-5:
        fail("the pion correlator is not the timeslice sum of |S_u|^2")
    # proton and neutron densities at 8 sites against the unfactored Wick sum
    proj = PROJECTORS["P+"]
    sub = {k: f[k][..., 5:6, 3:4, 16:24].contiguous() for k in ("u", "d")}
    for who, (a, c) in (("proton", ("u", "d")), ("neutron", ("d", "u"))):
        got = proton_2pt_site_dev(sub[a], sub[c], proj)
        want = plain_proton_density(sub[a], sub[c], proj)
        dev_n = ((got - want).abs().max() / want.abs().max()).item()
        print(f"  {who} density at 8 sites of timeslice 5 against the unfactored Wick sum: "
              f"max rel diff {dev_n:.2e} (limit 1e-5)")
        if not dev_n <= 1e-5:
            fail(f"the {who} density is not the Wick sum of its propagators")
    prot, neut = (res.correlators[f"twop/{w}/P+/{tag}"][0] for w in ("proton", "neutron"))
    print(f"  proton p=0 C(0) {prot[0]:.6e}, C(T/4) {prot[T // 4]:.6e}; neutron C(0) "
          f"{neut[0]:.6e}, C(T/4) {neut[T // 4]:.6e}")
    if have_h5py:
        from tpuqcd_torch.io.hdf5io import read_dataset
        run_twop.write(cfg, res)
        for group, corr in res.correlators.items():
            for i, mom in enumerate(res.momenta):
                back = read_dataset(cfg.physics.output,
                                    f"{group}/mom_{mom[0]}_{mom[1]}_{mom[2]}")
                if not (back == corr[i]).all():
                    fail(f"{group} read back from HDF5 differs")
        print(f"  HDF5: {len(res.correlators)} groups written and read back")
    else:
        print("  HDF5: h5py does not import here, the file is not written (the writer is "
              "held by tests/test_torch_twop.py)")


def ensemble_path(dev, files, plaquettes, have_h5py: bool):
    """4m: run_twop over the ensemble gauge.config_files = the chain's two
    files, as main loops it: per member of cli/common.ensemble_members
    (the second member's file read ahead on a thread while the first is
    measured, started once the first's read is taken) setup_gauge, then run_twop.measure with every column audited
    by the plain float64 operator; the first member (the chain's c0000) is
    cell 4h (check_twop).  The launch counts are set to 0 before the loop
    and read after the first member (4h's) and after the loop (4m's).
    Checks: each member's plaquette read back equal to the chain's
    (``plaquettes``) to 1e-12, every column of both members certified, the
    members' correlators apart, the per-member output names (the files'
    stems are the tags: '<root>.hb_b6_0000<ext>').  Returns (the first
    member's result, 4h's counts, 4m's counts, {ctag: (seconds by stage,
    gauge detail, {flavor: audit seconds})}, the read-ahead numbers)."""
    from tpuqcd_torch.cli import run_twop
    from tpuqcd_torch.cli.common import ensemble_members, setup_gauge
    from tpuqcd_torch.io.lime import read_ildg_payload
    from tpuqcd_torch.io.native import ildg_payload_to_device
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    lat = Lattice(LARGE)
    out, stats, corr = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = twop_config(os.path.join(tmp, "twop.h5"), gauge={"config_files": files})
        root, ext = os.path.splitext(cfg.physics.output)
        torch.cuda.synchronize()
        dslash_cuda.reset_counts()
        for i, (ctag, c) in enumerate(ensemble_members(cfg, dev)):
            if i == 0:
                say("phase 4h: main path, tpuqcd_torch.cli.run_twop.measure (direct, 12-column "
                    f"batches) at 32^3x64: ensemble member {ctag} (the chain's c0000)")
            else:
                say("phase 4m: the second member, the chain's c0001 (its file read ahead while "
                    "the first ran)")
            print(f"  === ensemble member {ctag} === output {c.physics.output}", flush=True)
            want = f"{root}.{os.path.splitext(os.path.basename(files[i]))[0]}{ext}"
            if c.physics.output != want:
                fail(f"member {ctag}'s output is {c.physics.output}, not {want}")
            detail = {}
            gauge = setup_gauge(c, dev, detail)
            if detail["scidac_checksum"] is None:
                fail(f"{ctag} was read without a verified scidac checksum")
            dplaq = abs(gauge.plaquette - plaquettes[i])
            print(f"  {io_line(f'{ctag} gauge', detail)}; plaquette {gauge.plaquette:.8f}, the "
                  f"chain's {plaquettes[i]:.8f} (|diff| {dplaq:.1e}, limit 1e-12)", flush=True)
            if not dplaq <= 1e-12:
                fail(f"member {ctag}'s plaquette read back is not the chain's")
            audited, audit_s = [], {+1: 0.0, -1: 0.0}
            u64 = gauge.u_pk.double()

            def audit(b, x, flavor):
                t0, plain = time.perf_counter(), dslash_cuda.counts["plain"]
                audited.append((flavor, b.shape[0], max(
                    plain_relres_cols(u64, b, x, lat, TWOP_KAPPA, TWOP_MU * flavor))))
                dslash_cuda.counts["plain"] = plain
                torch.cuda.synchronize()
                audit_s[flavor] += time.perf_counter() - t0

            res = run_twop.measure(c, dev, gauge, keep_fields=i == 0, audit=audit)
            torch.cuda.synchronize()
            counts = dict(dslash_cuda.counts)
            if counts.get("plain", 0) != 0:
                fail(f"member {ctag} called the plain version {counts['plain']} times")
            check_columns(res, audited, 24, f"member {ctag}")
            print(f"  {ctag} seconds by stage: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items())
                  + f" (the solves include the plain-operator audit, u {audit_s[+1]:.3f} s, "
                  f"d {audit_s[-1]:.3f} s)")
            stats[ctag] = (dict(res.seconds), detail, audit_s)
            corr[ctag] = res.correlators
            if i == 0:
                plain = dslash_cuda.counts["plain"]     # check_twop's residuals are no launches
                check_twop(res, counts, c, have_h5py)
                dslash_cuda.counts["plain"] = plain
                out["tw"] = (dataclasses.replace(
                    res, fields=None, u_pk=None,
                    solves=[{k: v for k, v in r.items() if k != "x_first"} for r in res.solves]),
                    counts)
            elif have_h5py:
                run_twop.write(c, res)
            del res, gauge, u64
            torch.cuda.empty_cache()
        counts = dict(dslash_cuda.counts)
    print(f"  launches during the ensemble run (both members): {counts}")
    need_launches(counts, ("float32:batch", "float64:batch", "float32", "float64"))
    (t0_, c0), (t1_, c1) = corr.items()
    diff = max(abs(c0[g] - c1[g]).max() / abs(c0[g]).max() for g in c0)
    print(f"  the members' correlators differ: max over groups of max |{t1_} - {t0_}| / max "
          f"|{t0_}| = {diff:.3e}")
    if not diff > 1e-3:
        fail("the two members' correlators do not differ")
    # the read-ahead: the host's wait at take(c0001) beside a synchronous read now
    t0 = time.perf_counter()
    payload = read_ildg_payload(files[1])
    t1 = time.perf_counter()
    u = ildg_payload_to_device(payload.data, lat, payload.precision, dev)
    torch.cuda.synchronize()
    sync_read = {"read": payload.seconds["read"], "checksum": payload.seconds["checksum"],
                 "decode": time.perf_counter() - t1, "total": t1 - t0}
    del u, payload
    second = stats[t1_][1]
    wait = second["take"]
    print(f"  take({t1_}) host wait {wait:.3f} s (its read {second['read']:.3f} s and checksum "
          f"{second['checksum']:.3f} s ran on the read-ahead thread during {t0_}); the same "
          f"file read synchronously after the run: read "
          f"{sync_read['read']:.3f} s, checksum {sync_read['checksum']:.3f} s, decode on the "
          f"card {sync_read['decode']:.3f} s")
    return out["tw"][0], out["tw"][1], counts, stats, {"wait": wait, "sync": sync_read}


def gauge_fix_path(dev, path: str, gauge):
    """4n: setup_gauge on the chain's member c0000 with gauge.fix landau at
    tpuqcd's defaults (200 sweeps, tol 1e-9), on the card.  Checks: the
    plaquette of the fixed links equals the file's to 1e-5, the functional
    rose; the gauge-invariant witness, per timeslice the sum of |x|^2 over
    the three colour columns of source spin 0 at the origin from batched CG
    on the fixed and on the unfixed gauge (``gauge``), agrees to 1e-5 of
    its largest value.  Returns (the fix's detail, the witness' counts,
    its seconds)."""
    from tpuqcd_torch.cli.common import setup_gauge
    from tpuqcd_torch.fields import apply_boundary_phase
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.ops.gauge_tools import plaquette
    from tpuqcd_torch.solve import solve_tm_batch
    from tpuqcd_torch.utils.packed import unpack_gauge
    lat = Lattice(LARGE)
    cfg = twop_config("unused.h5", gauge={"config_file": path, "fix": "landau",
                                          "plaquette_check": gauge.plaquette})
    detail = {}
    fixed = setup_gauge(cfg, dev, detail)
    hist = detail["fix_history"]
    print(f"  landau gauge fixing on the card: {detail['fix_sweeps']} sweeps in "
          f"{detail['fix_seconds']:.3f} s ({detail['fix_seconds'] / detail['fix_sweeps'] * 1e3:.2f}"
          f" ms a sweep), functional {detail['fix_initial']:.8f} before, {hist[0]:.8f} after the "
          f"first sweep, {hist[-1]:.8f} after the last (|dF| of the last sweep "
          f"{abs(hist[-1] - hist[-2]):.2e}, tol {cfg.gauge.fix_tol:.0e})")
    if not hist[-1] > detail["fix_initial"]:
        fail("the gauge fix did not raise the functional")
    u_fixed = apply_boundary_phase(unpack_gauge(fixed.u_pk), lat, "device", True)
    plaq = plaquette(u_fixed, lat)
    print(f"  plaquette of the fixed links {plaq:.8f}, of the file's {gauge.plaquette:.8f}: "
          f"|diff| {abs(plaq - gauge.plaquette):.2e} (limit 1e-5)")
    if not abs(plaq - gauge.plaquette) <= 1e-5:
        fail("gauge fixing changed the plaquette")
    del u_fixed
    b = point_columns(lat, dev, 3)
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    dens = {}
    for name, g in (("fixed", fixed), ("unfixed", gauge)):
        res = solve_tm_batch(g.u_pk, b, lat, kappa=TWOP_KAPPA, mu=TWOP_MU, tol=RELRES_MAX,
                             maxiter=5000, t_boundary=-1)
        if not max(res.relres) <= RELRES_MAX:
            fail(f"a witness column on the {name} gauge is not certified: {max(res.relres):.3e}")
        dens[name] = res.x.square().sum((0, 1, 2, 3, 4, 6, 7))
        print(f"  batched CG on the {name} gauge, 3 colour columns: certified relres <= "
              f"{max(res.relres):.2e}, matvecs {min(res.iters)}-{max(res.iters)}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(dslash_cuda.counts)
    print(f"  launches of the witness' solves: {counts}")
    if counts.get("plain", 0) != 0:
        fail("the witness called the plain version")
    need_launches(counts, ("float32:batch", "float64:batch"))
    a, c = dens["fixed"].cpu().numpy(), dens["unfixed"].cpu().numpy()
    dev_w = abs(a - c).max() / abs(c).max()
    print(f"  gauge-invariant witness, sum over colour columns and sink spin-colour of |x|^2 "
          f"per timeslice: t = 0 {c[0]:.6e}, t = T/2 {c[LARGE[3] // 2]:.6e}; fixed against "
          f"unfixed max |diff| / max {dev_w:.2e} (limit 1e-5)")
    if not dev_w <= 1e-5:
        fail("the propagator's gauge-invariant witness changed under the gauge fix")
    return detail, counts, seconds


def threep_path(dev, gauge, twop_proton, have_h5py: bool):
    """4j: run_threeptwop.measure at 32^3x64 on 4b's heatbath gauge with
    4h's action, solver and smearing, the projectors and baryons of
    examples/threep.yaml and t_sink THREEP_T_SINK; every column of every
    solver call certified by the solver and by the plain float64 operator
    (audited_measure); the two-point proton at P+ against 4h's
    ``twop_proton``.  Returns (result, counts, audit seconds)."""
    from tpuqcd_torch.cli import run_threeptwop
    from tpuqcd_torch.lattice import Lattice
    lat, u64 = Lattice(LARGE), gauge.u_pk.double()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = twop_config(os.path.join(tmp, "threep.h5"), projectors=["P+", "P5z"],
                          baryons=["proton", "neutron"], t_sinks=[THREEP_T_SINK],
                          sink_momentum=[0, 0, 0])
        res, counts, audited, audit_s, peak = audited_measure(run_threeptwop.measure, cfg, dev,
                                                              gauge, u64, lat)
        need_launches(counts, ("float32:batch", "float64:batch", "float32", "float64"))
        print("  seconds by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items())
              + f"; the plain-operator audit inside the solves {audit_s:.3f} s; peak "
              f"memory {peak:.2f} GiB")
        for rec, (flavor, n, worst) in zip(res.solves, audited):
            print(f"  flavor {flavor:+d} columns {rec['first_column']}-"
                  f"{rec['first_column'] + n - 1}: certified relres <= {max(rec['relres']):.3e}, "
                  f"matvecs {min(rec['iters'])}-{max(rec['iters'])}; plain-operator relres "
                  f"<= {worst:.3e}")
        check_columns(res, audited, 24 + 96, "the 24 forward and 96 backward columns")
        # the forward solves come first: two flavors of 12 columns
        if 24 not in itertools.accumulate(n for _, n, _ in audited):
            fail("the forward solves are not the first 24 columns")
        T = LARGE[3]
        corrs = dict(res.twop)
        corrs.update({f"{g}/{k}": v for g, ins in res.threep.items() for k, v in ins.items()})
        for name, corr in corrs.items():
            if not (corr.shape == (2, T) and bool(torch.isfinite(torch.from_numpy(corr)).all())):
                fail(f"{name}: shape {corr.shape} or non-finite values")
        if len(corrs) != 4 + 2 * 2 * 2 * 32:
            fail(f"{len(corrs)} correlators, not {4 + 2 * 2 * 2 * 32}")
        tag = "sx0sy0sz0st0"
        prot = res.twop[f"twop/proton/P+/{tag}"]
        dev_2 = abs(prot - twop_proton).max() / abs(twop_proton).max()
        print(f"  twop/proton/P+ against 4h's: max |diff| / max |4h| {dev_2:.2e} (limit 1e-10)")
        if not dev_2 <= 1e-10:
            fail("the three-point run's two-point proton differs from 4h's")
        gt_u = res.threep[f"threep/proton/P+/u/ts{THREEP_T_SINK}/{tag}"]["gt"][0]
        gt_d = res.threep[f"threep/proton/P+/d/ts{THREEP_T_SINK}/{tag}"]["gt"][0]
        ratio = (gt_u / gt_d)[1:THREEP_T_SINK].real
        print(f"  proton P+ p=0, gt insertion, u leg / d leg on t = 1..{THREEP_T_SINK - 1} "
              f"(about 2 expected, not a gate): {', '.join(f'{r:.4f}' for r in ratio)}")
        if have_h5py:
            from tpuqcd_torch.io.hdf5io import read_dataset
            run_threeptwop.write(cfg, res)
            group = f"threep_der/neutron/P5z/u/ts{THREEP_T_SINK}/{tag}"
            back = read_dataset(cfg.physics.output, f"{group}/der_g3_D3/mom_1_0_0")
            if not (back == res.threep[group]["der_g3_D3"][1]).all():
                fail(f"{group} read back from HDF5 differs")
            print("  HDF5: written and read back")
        else:
            print("  HDF5: h5py does not import here, the file is not written (the writer is "
                  "held by tests/test_torch_threeptwop.py)")
    return res, counts, audit_s


def loops_config(output: str, dims=LARGE, kappa=TWOP_KAPPA, mu=TWOP_MU, **physics):
    """4k's configuration (4h's gauge and action, direct CG): one Z4 noise in
    12 spin-colour classes, TSM with 4 cheap noises, 8 Lanczos modes, the
    33 momenta of q^2 <= 4; ``physics`` keys replace its physics block's
    (4l), ``dims``, ``kappa`` and ``mu`` its lattice and action (4u)."""
    from tpuqcd_torch.utils.config import config_from_dict
    return config_from_dict({
        "gauge": {"dims": list(dims), "heatbath_beta": MG_BETA,
                  "heatbath_sweeps": MG_SWEEPS, "random_seed": 0},
        "action": {"kappa": kappa, "mu": mu},
        "solver": {"solver": "cg", "sloppy_dtype": "float32", "rhs_batch": 12,
                   "tol": RELRES_MAX},
        "physics": {"n_noise": 1, "dilute_sc": True, "dilute_t": 1, "tsm_cheap": 4,
                    "tsm_maxiter_cheap": 50, "tsm_tol": 1e-3, "n_deflate": LOOPS_N_DEFLATE,
                    "mom_max_sq": 4, "output": output, **physics}})


def audited_measure(measure, cfg, dev, gauge, u64, lat, on_column=None, **kw):
    """measure(cfg, dev, gauge, audit=..., **kw) with the launch counts set
    to 0 just before and read just after, every solver column held to the
    plain float64 operator at cfg's action (its plain calls taken back out
    of the count), and on_column(source, flavor) called on each column's
    source.  Returns (result, counts, [(flavor, columns, worst plain
    relres)], audit seconds, peak GiB)."""
    from tpuqcd_torch.ops import dslash_cuda
    audited, audit_s = [], [0.0]

    def audit(b, x, flavor):
        t0, plain = time.perf_counter(), dslash_cuda.counts["plain"]
        rels = plain_relres_cols(u64, b, x, lat, cfg.action.kappa, cfg.action.mu * flavor)
        for i in range(b.shape[0]):
            if on_column is not None:
                on_column(b[i], flavor)
        dslash_cuda.counts["plain"] = plain
        torch.cuda.synchronize()
        audit_s[0] += time.perf_counter() - t0
        audited.append((flavor, len(rels), max(rels)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dslash_cuda.reset_counts()
    res = measure(cfg, dev, gauge, audit=audit, **kw)
    torch.cuda.synchronize()
    counts = dict(dslash_cuda.counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the path called the plain version {counts['plain']} times")
    return res, counts, audited, audit_s[0], peak


def check_columns(res, audited, n_columns: int, what: str) -> None:
    """Every column certified by the solver and by the plain operator."""
    if len(audited) != len(res.solves) or sum(n for _, n, _ in audited) != n_columns:
        fail(f"{what}: {sum(n for _, n, _ in audited)} columns audited in {len(audited)} "
             f"calls, not {n_columns} in {len(res.solves)}")
    for rec, (flavor, n, worst) in zip(res.solves, audited):
        if not (rec["flavor"] == flavor and rec["columns"] == n):
            fail(f"{what}: the audit does not follow the solver's calls")
        if not (max(rec["relres"]) <= RELRES_MAX and worst <= RELRES_MAX):
            fail(f"{what}: a column is not certified: solver {max(rec['relres']):.3e}, plain "
                 f"{worst:.3e}")
    print(f"  {what}: all {n_columns} columns certified <= {RELRES_MAX:.0e} by the solver "
          f"(<= {max(max(r['relres']) for r in res.solves):.2e}) and by the plain float64 "
          f"operator (<= {max(w for _, _, w in audited):.2e})")


def check_loops(res, n_mom: int, groups) -> None:
    T = LARGE[3]
    if sorted(res.loops) != sorted(groups):
        fail(f"datasets {sorted(res.loops)}, not {sorted(groups)}")
    for group, loops in res.loops.items():
        want = 16 if group.count("_der") == 0 else 64
        if len(loops) != want:
            fail(f"{group}: {len(loops)} insertions, not {want}")
        for name, v in loops.items():
            if not (v.shape == (n_mom, T) and np.isfinite(v).all()):
                fail(f"{group}/{name}: shape {v.shape} or non-finite values")
    print(f"  {', '.join(groups)}: every insertion finite, shape ({n_mom}, {T})")


def loops_path(dev, gauge, have_h5py: bool):
    """4k: run_loops.measure at 32^3x64 on 4b's gauge (loops_config): every
    full and low-mode column certified by the solver and by the plain
    float64 operator, the Lanczos basis orthonormal with positive ascending
    Rayleigh quotients, every deflated source orthogonal to it, the saved
    eigenpairs equal to the basis, every dataset finite.  Returns (result
    without its fields, counts, audit seconds, peak GiB)."""
    from tpuqcd_torch.cli import run_loops
    from tpuqcd_torch.cli.common import _mg_fine_level
    from tpuqcd_torch.gammas import G5_DIAG
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.checkpoint import load_eigenpairs
    lat, u64 = Lattice(LARGE), gauge.u_pk.double()
    g5 = torch.tensor(G5_DIAG, dtype=torch.float64, device=dev).view(4, 1, 1, 1, 1)
    with tempfile.TemporaryDirectory() as tmp:
        eig = os.path.join(tmp, "eig.npz")
        cfg = loops_config(os.path.join(tmp, "loops.h5"), eig_outfile=eig)
        basis, overlaps = [], []

        def on_column(b, flavor):
            """The overlap of a source with the basis, |V^dag s| / |s|: the
            sources of the noise's solves come first (the dilution classes,
            deflated), then the low modes themselves."""
            if not basis:        # the Lanczos stage wrote it before any solve
                evecs = torch.stack(load_eigenpairs(eig)[1]).to(dev).transpose(1, 2)
                basis.append(torch.complex(evecs[:, :, 0].double(),
                                           evecs[:, :, 1].double()).reshape(len(evecs), -1))
            s = (b.double() * g5).transpose(0, 1)                  # undo the g5, ri first
            c = torch.complex(s[0], s[1]).reshape(-1)
            overlaps.append(((basis[0].conj() @ c).abs().max() / c.abs().pow(2).sum().sqrt())
                            .item())

        res, counts, audited, audit_s, peak = audited_measure(
            run_loops.measure, cfg, dev, gauge, u64, lat, on_column, keep_fields=True)
        need_launches(counts, ("float32:batch", "float64:batch", "float32", "float64"))
        print("  seconds by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items())
              + f"; the plain-operator audit inside the solves {audit_s:.3f} s; peak memory "
              f"{peak:.2f} GiB")
        n_classes, n_def = 12, LOOPS_N_DEFLATE
        check_columns(res, audited, n_classes + n_def, "the noise's 12 classes and 8 low modes")
        defl = max(overlaps[:n_classes])
        print(f"  deflated sources: max |V^dag s| / |s| {defl:.2e} (limit {BASIS_TOL:.0e}); the "
              f"low modes' own {min(overlaps[n_classes:]):.3f}-{max(overlaps[n_classes:]):.3f}")
        if not defl <= BASIS_TOL:
            fail("a deflated source is not orthogonal to the deflation basis")
        # the basis: orthonormal, ascending positive Rayleigh quotients, residuals
        v = res.evecs.reshape(n_def, 2, -1).double()
        vc = torch.complex(v[:, 0], v[:, 1])
        gram = (vc.conj() @ vc.T - torch.eye(n_def, device=dev)).abs().max().item()
        lv_p, lv_m = (_mg_fine_level(cfg, lat, gauge.u_pk, f) for f in (+1, -1))
        g5mg = g5.to(torch.float32)[None]
        resid = []
        for lam, x in zip(res.evals, res.evecs):
            ax = lv_m.apply(g5mg * lv_p.apply(g5mg * x))
            resid.append(((ax - lam * x).double().square().sum().sqrt() / lam).item())
        print(f"  Lanczos basis: |V^dag V - 1|_max {gram:.2e} (limit {BASIS_TOL:.0e}); Rayleigh "
              f"quotients {', '.join(f'{e:.5e}' for e in res.evals)}; |Av - lv| / l "
              f"{', '.join(f'{r:.2e}' for r in resid)}")
        if not (gram <= BASIS_TOL and (res.evals > 0).all() and (np.diff(res.evals) >= 0).all()):
            fail("the Lanczos basis is not orthonormal, or its Rayleigh quotients are not "
                 "positive and ascending")
        evals, evecs = load_eigenpairs(eig, expect_layout="packed", n_expect=n_def)
        same = (np.array_equal(evals, res.evals)
                and torch.equal(torch.stack(evecs), res.evecs.cpu()))
        print(f"  eig_outfile read back: {'equal' if same else 'NOT equal'} to the basis in "
              f"memory bit for bit")
        if not same:
            fail("the saved eigenpairs differ from the basis in memory")
        check_loops(res, len(cfg.physics.momenta), ["loops/oneend", "loops/oneend_der",
                                                    "loops/oneend_lowmode",
                                                    "loops/oneend_lowmode_der"])
        for name in ("1", "g5"):
            full, cheap = res.tsm["full"][name], res.tsm["cheap"][name]
            print(f"  TSM correction {name}: |full - cheap| / |full| "
                  f"{np.linalg.norm(full - cheap) / np.linalg.norm(full):.3e}")
        g5l = res.loops["loops/oneend"]["g5"][0]
        print(f"  oneend g5 p=0, t=0..3: {', '.join(f'{z:.4e}' for z in g5l[:4])}")
        if have_h5py:
            from tpuqcd_torch.io.hdf5io import read_dataset
            run_loops.write(cfg, res)
            back = read_dataset(cfg.physics.output, "loops/oneend_der/g5gt_D3")
            if not (back == res.loops["loops/oneend_der"]["g5gt_D3"]).all():
                fail("loops/oneend_der read back from HDF5 differs")
            print("  HDF5: written and read back")
        else:
            print("  HDF5: h5py does not import here, the file is not written (the writer is "
                  "held by tests/test_torch_run_loops.py)")
    return dataclasses.replace(res, evecs=None, u_pk=None), counts, audit_s, peak


def deflation_witness(es, inner_tol: float, shape) -> None:
    """4l's witness that the space eigCG harvested deflates, on a fresh
    right-hand side of the inner system Mhat^dag Mhat x = Mhat^dag bhat of
    es (an EigCGSolver after the run): x* by plain CG to inner_tol, and
    the share of its A-norm that the space's guess x0 = U diag(1/lambda)
    U^dag rhs misses, |x* - x0|_A / |x*|_A, held below 1 (x0 is the
    Galerkin guess); the iterations without and with the space; the
    space's lowest Rayleigh quotients with |Av - lambda v| / lambda beside
    a 40-step Lanczos on the same operator, the space's lowest held within
    WITNESS_RQ of Lanczos's; the spread lambda_k / lambda_1, whose root is
    the fall of the iterations that deflating those k modes exactly could
    give; and beside the path's guess the Galerkin guess U (U^dag A U)^-1
    U^dag rhs, what a Rayleigh-Ritz over the whole space would give."""
    from tpuqcd_torch.solve import EIGCG_M, EIGCG_NEV
    from tpuqcd_torch.solvers.eigcg import eigcg
    from tpuqcd_torch.solvers.lanczos import lanczos_lowest_pk
    from tpuqcd_torch.utils import pkalg as pk
    a, space, dev = es._apply_a, es.space, es.u32.device
    b = torch.randn((2, 2, 4, 3, *shape), generator=torch.Generator().manual_seed(31),
                    dtype=torch.float64).to(dev)
    rhs = es.pc.apply_dagger(es.u32, es.pc.prepare(es.u_hp, b).to(torch.float32))
    plain = eigcg(a, rhs, nev=EIGCG_NEV, m=EIGCG_M, tol=inner_tol, maxiter=4000)
    defl = eigcg(a, rhs, nev=EIGCG_NEV, m=EIGCG_M, tol=inner_tol, maxiter=4000, space=space)

    def anorm2(v):
        return pk.cdot(v, a(v), dtype=torch.float64)[0].item()

    miss = (anorm2(plain.x - space.deflate(rhs)) / anorm2(plain.x)) ** 0.5
    U = torch.stack(space.evecs).reshape(space.k, 2, -1)

    def herm(p, q):
        """p^dag q for stacks of packed fields [k, 2(ri), N]: complex128 [k, n]."""
        re = p[:, 0] @ q[:, 0].T + p[:, 1] @ q[:, 1].T
        im = p[:, 0] @ q[:, 1].T - p[:, 1] @ q[:, 0].T
        return torch.complex(re.double(), im.double()).cpu().numpy()

    h = np.concatenate([herm(U, torch.stack([a(v) for v in space.evecs[i:i + 16]])
                             .reshape(-1, 2, U.shape[2])) for i in range(0, space.k, 16)], 1)
    y = np.linalg.solve(h, herm(U, rhs.reshape(1, 2, -1))[:, 0])
    yr, yi = (torch.as_tensor(z, dtype=torch.float32, device=dev) for z in (y.real, y.imag))
    x0g = torch.stack([yr @ U[:, 0] - yi @ U[:, 1], yr @ U[:, 1] + yi @ U[:, 0]])
    miss_g = (anorm2(plain.x - x0g.reshape(rhs.shape)) / anorm2(plain.x)) ** 0.5
    off = np.abs(h - np.diag(np.diag(h))).max() / np.abs(np.diag(h)).min()
    del U, x0g
    order = np.argsort(space.evals)
    low = [(space.evals[i], space.evecs[i]) for i in order[:4]]
    resid = [(pk.norm2(a(v) - lam * v, dtype=torch.float64).sqrt() / lam).item()
             for lam, v in low]
    v0 = torch.randn(rhs.shape, generator=torch.Generator().manual_seed(9))
    lz, _ = lanczos_lowest_pk(a, v0.to(dev), 4, n_iter=40)
    spread = space.evals[order[-1]] / space.evals[order[0]]
    print(f"  deflation witness (a fresh right-hand side, flavor +1): plain CG {plain.iters} "
          f"iterations, with the space of k = {space.k} {defl.iters}; the deflated guess "
          f"misses {miss:.7f} of the solution's A-norm (limit < 1; it holds {1 - miss ** 2:.3e} "
          f"of its square), the Galerkin guess {miss_g:.7f} ({1 - miss_g ** 2:.3e}); U^dag A "
          f"U's largest off-diagonal over its smallest diagonal {off:.3e}")
    print(f"  the space's lowest Rayleigh quotients {', '.join(f'{lam:.5e}' for lam, _ in low)} "
          f"(|Av - lv| / l {', '.join(f'{r:.2e}' for r in resid)}); 40-step Lanczos on the same "
          f"operator {', '.join(f'{e:.5e}' for e in lz)}; spread lambda_k / lambda_1 "
          f"{spread:.3f} (exact deflation of these modes: iterations x "
          f"{spread ** -0.5:.3f} at best)")
    if not (plain.converged and defl.converged and miss < 1.0):
        fail("the witness's solves did not converge, or the deflated guess is no better than 0")
    if not low[0][0] <= WITNESS_RQ * lz[0]:
        fail(f"the eigCG space's lowest Rayleigh quotient {low[0][0]:.3e} is not within "
             f"{WITNESS_RQ} of Lanczos's {lz[0]:.3e}: the space misses the low modes")


def eigcg_path(dev, gauge):
    """4l: 4k's configuration without TSM and deflation, once with the
    batched CG and once with eigCG on the same seed-17 noise: every column
    of both held to the plain float64 operator, the loops of the two within
    LOOPS_AGREE of each dataset's largest value, then deflation_witness on
    the eigCG run's space.  Returns (eigCG result, eigCG counts, CG counts,
    CG seconds by stage, the batched CG's launch widths)."""
    from unittest import mock

    from tpuqcd_torch.cli import run_loops
    from tpuqcd_torch.cli.common import make_solver
    from tpuqcd_torch.lattice import Lattice
    lat, u64 = Lattice(LARGE), gauge.u_pk.double()
    runs, made = {}, []

    def keep(*args):
        """make_solver, the Solver kept for the witness."""
        made.append(make_solver(*args))
        return made[-1]

    for solver in ("cg", "eigcg"):
        cfg = loops_config("unused.h5", tsm_cheap=0, n_deflate=0)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, solver=solver))
        print(f"  solver {solver}:")
        with mock.patch.object(run_loops, "make_solver", keep):
            res, counts, audited, audit_s, peak = audited_measure(run_loops.measure, cfg, dev,
                                                                  gauge, u64, lat)
        need_launches(counts, ("float32", "float64") if solver == "eigcg"
                      else ("float32:batch", "float64:batch", "float32", "float64"))
        print("  seconds by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items())
              + f"; the audit {audit_s:.3f} s; peak memory {peak:.2f} GiB")
        check_columns(res, audited, 12, f"{solver}: the noise's 12 classes")
        check_loops(res, len(cfg.physics.momenta), ["loops/oneend", "loops/oneend_der"])
        runs[solver] = (res, counts)
    cg, eig = runs["cg"][0], runs["eigcg"][0]
    print(f"  eigCG iterations per column: {[r['iters'][0] for r in eig.solves]}; final space "
          f"k = {eig.solves[-1]['space']}; the batched CG's matvecs per column "
          f"{[i for r in cg.solves for i in r['iters']]}")
    worst = 0.0
    for group in ("loops/oneend", "loops/oneend_der"):
        for name, a in cg.loops[group].items():
            worst = max(worst, np.abs(eig.loops[group][name] - a).max() / np.abs(a).max())
    print(f"  eigCG against the batched CG, every dataset: max |diff| / max |CG| {worst:.2e} "
          f"(limit {LOOPS_AGREE:.0e})")
    if not worst <= LOOPS_AGREE:
        fail("the eigCG loops differ from the batched CG's")
    deflation_witness(made[-1].eigcg[+1], cfg.solver.inner_tol, lat.site_shape)
    cg_widths = sorted({rec["columns"] for rec in cg.solves if rec["columns"] > 1})
    return eig, runs["eigcg"][1], runs["cg"][1], cg.seconds, cg_widths


def plain_proton_density(su, sd, proj) -> torch.Tensor:
    """The proton's Wick sum at every site of packed propagators [2(ri),
    2(par), 4, 3, 4, 3, T, Z, S], unfactored, in complex128 (for a handful
    of sites): with W = G Sd G~, G = C g5,
      sum proj[n,m] eps_abc eps_def (Su[m,a,n,d] Su[r,b,v,e]
                                     - Su[m,a,v,e] Su[r,b,n,d]) W[r,c,v,f]
    -> packed density [2(ri), 2(par), T, Z, S] float64."""
    from tpuqcd_torch.gammas import CGAMMA5, EPS3, gbar
    dev, cdt = su.device, torch.complex128
    u, d = (torch.complex(p[0].double(), p[1].double()) for p in (su, sd))
    g, gt = CGAMMA5.to(dev, cdt), gbar(CGAMMA5).to(dev, cdt)
    eps, pr = EPS3.to(dev, cdt), torch.as_tensor(proj).to(dev, cdt)
    w = torch.einsum("rs,pscuftzx,uv->prcvftzx", g, d, gt)
    uu = (torch.einsum("pmandtzx,prbvetzx->pmandrbvetzx", u, u)
          - torch.einsum("pmavetzx,prbndtzx->pmandrbvetzx", u, u))
    dens = torch.einsum("nm,abc,def,pmandrbvetzx,prcvftzx->ptzx", pr, eps, eps, uu, w)
    return torch.stack([dens.real, dens.imag])


def point_columns(lat, dev, n: int) -> torch.Tensor:
    """The first n point-source columns at the origin, packed float32
    [n, 2(par), 2(ri), 4, 3, T, Z, S]."""
    from tpuqcd_torch.phys.propagator import full_to_packed
    cols = []
    for i in range(n):
        src = torch.zeros((*lat.full_shape, 4, 3), dtype=torch.complex64, device=dev)
        src[0, 0, 0, 0, i // 3, i % 3] = 1.0
        cols.append(full_to_packed(src, lat))
    return torch.stack(cols)


def mg_batch_path(dev, mg, u_pk):
    """4i: MGB_COLUMNS point-source columns through solve_tm_mg_batch on
    4b's hierarchy, then the same columns one by one; returns (batch
    seconds, single seconds, iterations, counts)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.solve import solve_tm_mg, solve_tm_mg_batch
    lat = Lattice(LARGE)
    b = point_columns(lat, dev, MGB_COLUMNS)
    print(f"  the GCR basis and work fields of {MGB_COLUMNS} columns: "
          f"{mg.batch_bytes(MGB_COLUMNS) / 2**30:.1f} GiB "
          f"(12 columns: {mg.batch_bytes(12) / 2**30:.1f} GiB, refused by the memory check)")
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    res = solve_tm_mg_batch(mg, b, tol=RELRES_MAX, inner_tol=1e-7)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail("the batched MG path called the plain version")
    need_launches(counts, ("float32:batch", "bfloat16:batch", "float64:batch"))
    rel = plain_full_relres(u_pk.double(), b[0].double(), res.x[0], lat, MG_KAPPA, MG_MU)
    print(f"  {MGB_COLUMNS} columns in lockstep: certified relres {', '.join(f'{r:.3e}' for r in res.relres)}"
          f"; column 0 plain-operator relres {rel:.3e}; {res.iters[0]} inner iterations, "
          f"{res.refinements[0]} refinements, {t_batch:.2f} s")
    if not (max(res.relres) <= RELRES_MAX and rel <= RELRES_MAX):
        fail("a lockstep MG column is not certified")
    x_batch = res.x
    del res
    t0 = time.perf_counter()
    singles = [solve_tm_mg(mg, b[i], tol=RELRES_MAX, inner_tol=1e-7)
               for i in range(MGB_COLUMNS)]
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    agree = max(((x_batch[i] - r.x).abs().max() / r.x.abs().max()).item()
                for i, r in enumerate(singles))
    print(f"  the same {MGB_COLUMNS} columns one by one: {t_single:.2f} s, inner iterations "
          f"{[r.iters for r in singles]}, relres <= {max(r.relres for r in singles):.3e}; "
          f"max |x - x(lockstep)| / |x| {agree:.3e} (limit {X_AGREE:.0e}); lockstep is "
          f"{t_single / t_batch:.2f}x faster")
    if not (max(r.relres for r in singles) <= RELRES_MAX and agree <= X_AGREE):
        fail("the single MG solves are not certified or do not agree with the lockstep ones")
    refused = False
    try:
        mg._check_batch_fits(64)
    except MemoryError as e:
        refused = True
        print(f"  memory check: {e}")
    if not refused:
        fail("the memory check let 64 columns through")
    return t_batch, t_single, [r.iters for r in singles], counts


@contextlib.contextmanager
def solve_peak():
    """Within it, every cli/common.MGSolver solve records the device memory
    allocated as it starts ("base") and the most allocated while it runs
    ("peak": torch.cuda.max_memory_allocated, reset as it starts)."""
    from tpuqcd_torch.cli import common
    call, rec = common.MGSolver.__call__, {}

    def peaked(self, *args, **kw):
        torch.cuda.synchronize()
        rec["base"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call(self, *args, **kw)
        torch.cuda.synchronize()
        rec["peak"] = torch.cuda.max_memory_allocated()
        return out

    common.MGSolver.__call__ = peaked
    try:
        yield rec
    finally:
        common.MGSolver.__call__ = call


def bf16_params(params):
    """MG params with both bfloat16 solver buffers (mg.gcr_dtype, vec_dtype)."""
    return dataclasses.replace(params, gcr_dtype="bfloat16", vec_dtype="bfloat16")


def mg_bf16_twin(mg):
    """4v, first half: the bfloat16-buffer twin of 4b's hierarchy (DeviceMG.
    rebuilt: the same null vectors rounded to bfloat16, Linv from the rounded
    bank, the Galerkin links probed again), with the launch counts set to 0
    just before; and restrict + prolong, as a V-cycle runs them, timed on
    both banks (CUDA events, 20 after 2).  Returns (twin, {"build": seconds,
    "float32" and "bfloat16": ms})."""
    from tpuqcd_torch.ops import dslash_cuda
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    twin = mg.rebuilt(bf16_params(mg.params))
    torch.cuda.synchronize()
    out = {"build": time.perf_counter() - t0}
    lv = mg.levels[0]
    r = torch.randn((2, 2, 4, 3, *lv.lat.site_shape), device=lv.device,
                    generator=torch.Generator(device=lv.device).manual_seed(11))
    for key, tr in (("float32", mg.transfers[0]), ("bfloat16", twin.transfers[0])):
        out[key] = time_ms(lambda: tr.prolong(tr.restrict(r)), reps=20)
    return twin, out


def admitted_columns(mg) -> int:
    """The most columns (up to 64) _check_batch_fits lets through."""
    n = 0
    while n < 64:
        try:
            mg._check_batch_fits(n + 1)
        except MemoryError:
            break
        n += 1
    return n


def mg_bf16_path(dev, twin, mg_res, f32_peak, built):
    """4v, second half: 4b's source solved to 1e-10 on the twin, both buffers
    in bfloat16 (4b's float32 hierarchy freed first: the twin shares its fine
    level), its peak allocation beside 4b's solve's on the float32 hierarchy
    (solve_peak), and the columns _check_batch_fits admits with the float32
    and the bfloat16 GCR basis.  Fails unless the solve is certified by the
    solver and by the plain float64 operator, the peak drops by at least
    PEAK_DROP_SHARE of the reckoned drop (half the basis, 2 restart fine
    fields, and half the bank, n_vec fine fields), the bfloat16 basis admits
    more columns, and the twin's build and solve launched the kernels
    (float32, bfloat16, float64, legs_out) and no plain call.  Returns
    (result, counts, seconds, peak bytes)."""
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.solve import solve_tm_mg
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve_tm_mg(twin, mg_res.b_pk, tol=RELRES_MAX, inner_tol=1e-7)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the twin's build and solve: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the bfloat16-buffer MG called the plain version {counts['plain']} times")
    need_launches(counts, ("float32", "bfloat16", "float64", "float32:legs_out"))
    rel = plain_full_relres(mg_res.u_pk.double(), mg_res.b_pk.double(), res.x,
                            twin.levels[0].lat, MG_KAPPA, MG_MU)
    p = twin.params
    field = twin._fine_field_bytes()
    reckoned = (p.restart + p.n_vec[0] // 2) * field
    drop = f32_peak["peak"] - peak
    admits = {}
    for gcr in ("float32", "bfloat16"):
        probe = copy.copy(twin)
        probe.params = dataclasses.replace(p, gcr_dtype=gcr)
        admits[gcr] = admitted_columns(probe)
    print(f"  twin built in {built['build']:.2f} s (Linv and probing; no null-vector solve); "
          f"restrict + prolong per V-cycle: float32 bank {built['float32']:.3f} ms, bfloat16 "
          f"bank {built['bfloat16']:.3f} ms")
    print(f"  certified relres {res.relres:.3e}, plain-operator relres {rel:.3e}; inner "
          f"iterations {res.iters} (4b, float32 buffers: {mg_res.iters}), refinements "
          f"{res.refinements} (4b: {mg_res.refinements}); solve {seconds:.3f} s (4b: "
          f"{mg_res.seconds:.3f} s)")
    print(f"  peak allocation of the solve: float32 buffers (4b) {f32_peak['peak'] / 1e9:.3f} GB "
          f"(allocated at its start {f32_peak['base'] / 1e9:.3f} GB), bfloat16 buffers "
          f"{peak / 1e9:.3f} GB (at its start {base / 1e9:.3f} GB): {drop / 1e9:.3f} GB lower; "
          f"reckoned {reckoned / 1e9:.3f} GB ({p.restart} + {p.n_vec[0] // 2} fine fields of "
          f"{field / 1e6:.1f} MB), limit {PEAK_DROP_SHARE:.0%} of it")
    print(f"  columns _check_batch_fits admits: float32 basis {admits['float32']}, bfloat16 "
          f"basis {admits['bfloat16']}")
    if not (res.relres <= RELRES_MAX and rel <= RELRES_MAX and torch.isfinite(res.x).all()):
        fail("the bfloat16-buffer MG solve is not certified")
    if not drop >= PEAK_DROP_SHARE * reckoned:
        fail(f"the bfloat16 buffers lowered the solve's peak by {drop / 1e9:.3f} GB, under "
             f"{PEAK_DROP_SHARE:.0%} of the reckoned {reckoned / 1e9:.3f} GB")
    if not admits["bfloat16"] > admits["float32"]:
        fail("the bfloat16 GCR basis does not admit more lockstep columns")
    return res, counts, seconds, peak


def lockstep_admitted_path(dev, twin, mg_res):
    """4w: solve_certified_batch on 4v's bfloat16-buffer twin at the width the
    lockstep memory check admits, the columns (4b's source, then point
    sources at the origin, as mg_lockstep_memory.py takes them) allocated
    first, as a caller hands them over: its first refinement's first GCR
    cycle between the float64 residuals (maxiter = restart, max_refine = 1),
    where the whole solve's peak already falls (mg_lockstep_memory.py ran the
    width to the end, every column certified: PERF.md section 5), with the
    launch counts set to 0 just before.  Checks: the peak growth (max memory
    allocated past the call's start) at or below batch_bytes(N); every
    column's float64 residual after the cycle below 1 and equal to the plain
    float64 operator's on the returned x to LOCKSTEP_RES_AGREE; the batched
    float32, bfloat16 and float64 launches and no plain call; one column
    more refused before allocating.  Returns (N, seconds, counts)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    lat = Lattice(LARGE)

    def cols(n):
        b = [mg_res.b_pk.to(torch.float32)[None]]
        if n > 1:
            b.append(point_columns(lat, dev, n - 1))
        return torch.cat(b).transpose(1, 2).contiguous()

    n = admitted_columns(twin) + 1
    while True:
        b = cols(n)
        try:
            twin._check_batch_fits(n)
            break
        except MemoryError:
            del b
            n -= 1
    need = twin.batch_bytes(n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    res = twin.solve_certified_batch(b, tol=RELRES_MAX, inner_tol=1e-7,
                                     maxiter=twin.params.restart, max_refine=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    growth = torch.cuda.max_memory_allocated() - base
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the cycle: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the lockstep MG called the plain version {counts['plain']} times")
    need_launches(counts, ("float32:batch", "bfloat16:batch", "float64:batch"))
    field = twin._fine_field_bytes()
    plain = plain_relres_cols(mg_res.u_pk.double(), b.transpose(1, 2),
                              res.x.transpose(1, 2), lat, MG_KAPPA, MG_MU)
    agree = max(abs(p - r) / p for p, r in zip(plain, res.relres))
    print(f"  {n} columns admitted with them allocated; one GCR cycle of {res.iters} "
          f"iterations between the float64 residuals in {seconds:.2f} s; relres after it "
          f"{min(res.relres):.3e}-{max(res.relres):.3e}, the plain float64 operator's on the "
          f"same x within {agree:.1e} of them (limit {LOCKSTEP_RES_AGREE:.0e})")
    print(f"  peak growth {growth / 1e9:.3f} GB ({growth / field:.2f} fine fields), "
          f"batch_bytes({n}) {need / 1e9:.3f} GB ({need / field:.2f}): "
          + ", ".join(f"{k} {v / field:.2f}" for k, v in twin.batch_buffers(n).items()))
    if not (growth <= need and max(res.relres) < 1.0 and agree <= LOCKSTEP_RES_AGREE
            and bool(torch.isfinite(res.x).all())):
        fail("the lockstep MG at the admitted width grew past batch_bytes, or its residuals "
             "are not the plain operator's")
    del res, b
    torch.cuda.empty_cache()
    b = cols(n + 1)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        twin.solve_certified_batch(b, tol=RELRES_MAX, inner_tol=1e-7)
        fail(f"the memory check let {n + 1} columns through")
    except MemoryError as e:
        if torch.cuda.max_memory_allocated() != before:
            fail("the memory check refused after allocating")
        print(f"  {n + 1} columns refused before allocating: {e}")
    del b
    torch.cuda.empty_cache()
    return n, seconds, counts


def mesh_mg_bf16_path(dev, mg, mp_res, mp_twin, gauge):
    """4v on a mesh: 4p's sharded hierarchy's bfloat16-buffer twin (DeviceMG.
    rebuilt, the probing in K6 dirs launches) solves 4p's source to 1e-10:
    certified by the solver and the plain float64 operator, its inner
    iterations beside 4p's.  Returns (seconds, counts)."""
    from tpuqcd_torch.solve import solve_tm_mg

    def run():
        twin = mg.rebuilt(bf16_params(mg.params))
        return solve_tm_mg(twin, mp_twin.b_pk, tol=RELRES_MAX, inner_tol=1e-7)
    res, seconds, counts = _counted(run)
    print(f"  launches during the twin's build and solve: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the sharded bfloat16-buffer MG called the plain version {counts['plain']} times")
    need_launches(counts, ("float32:halo", "bfloat16:halo", "float64:halo", "float32:dirs:halo"))
    rel = plain_full_relres(gauge.u_pk.double(), mp_twin.b_pk.double(), res.x, mg.lmesh.lat,
                            MG_KAPPA, MG_MU)
    print(f"  certified relres {res.relres:.3e}, plain-operator relres {rel:.3e}; inner "
          f"iterations {res.iters} (4p, float32 buffers: {mp_res.iters}), refinements "
          f"{res.refinements}; twin build and solve {seconds:.3f} s")
    if not (res.relres <= RELRES_MAX and rel <= RELRES_MAX):
        fail("the sharded bfloat16-buffer MG solve is not certified")
    return seconds, counts


def slim(result):
    """An InvertResult without its fields and hierarchy, to free the card."""
    import dataclasses
    out = dataclasses.replace(result, x=None, u_pk=None, b_pk=None, mg=None)
    torch.cuda.empty_cache()
    return out


def new_compares(dev):
    """Phase 3 of the two-point slice: the batch axis at 8^3x16 (at 32^3x64
    it follows 4h and 4i, with their numbers of columns), reconstruct-8 and
    compute="bf16" against their plain versions at 8^3x16 and 32^3x64;
    returns the latter two's max abs errors at 32^3x64."""
    say("phase 3: the batch axis against single launches and the plain version")
    torch.cuda.empty_cache()
    compare_batch(SMALL, dev, (1, 3, 5, 12))
    say("phase 3: reconstruct-8 (K5) against the plain version and the 18-real kernel")
    compare_recon8(SMALL, dev)
    r8_abs = compare_recon8(LARGE, dev)
    say('phase 3: compute="bf16" against its plain version and float32 arithmetic')
    compare_bf16c(SMALL, dev)
    bf16c_abs = compare_bf16c(LARGE, dev)
    torch.cuda.empty_cache()
    return r8_abs, bf16c_abs


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bytes_per_site(dt, rows, xpay, clover=False) -> tuple[int, int]:
    """(naive, compulsory) device-memory bytes per output site.  Naive
    reads the 8 neighbour spinors and 8 links, stores one spinor and, for
    xpay, reads psi0; compulsory reads each spinor once, since a neighbour
    spinor read by 8 sites can come from the caches (links, and the 144
    reals of a clover block, are each read once either way)."""
    item = torch.empty((), dtype=dt).element_size()
    spinor, link = 24 * item, rows * 6 * item
    tail = 8 * link + spinor + (spinor if xpay else 0) + (144 * item if clover else 0)
    return 8 * spinor + tail, spinor + tail


def bound(byts: float, flops: float, dt) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: the
    compulsory bytes at 3.35 TB/s or the flops at the peak for dt."""
    tb, tf = byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def one_site_beside(label, key, row, pair, one_site, card_tag) -> dict:
    """A bfloat16 row (ms, plain ms, bound ms, bound by) of the pair kernel
    timed again beside the one-site kernel on the same operands, in turns
    (pair, one-site, one-site, pair; 50 launches each after 10 to warm
    up), each the least of its turns, with their shares of the bound.
    Returns {(storage, tag): the pair kernel's row, (storage, tag +
    ":one_site"): the one-site kernel's, with the same plain time}."""
    _, p_ms, b_ms, b_by = row
    turns = {"pair": [], "one": []}
    for which in ("pair", "one", "one", "pair"):
        turns[which].append(time_ms(pair if which == "pair" else one_site, reps=50, warmup=10))
    k_ms, o_ms = min(turns["pair"]), min(turns["one"])
    print(f"{label} in turns: pair kernel {k_ms:.4f} ms ({b_ms / k_ms:.1%} of its bound), "
          f"one-site kernel {o_ms:.4f} ms ({b_ms / o_ms:.1%}); bound {b_ms:.4f} ms by {b_by} | "
          f"{card_tag}")
    return {key: (k_ms, p_ms, b_ms, b_by), (key[0], key[1] + ":one_site"): (o_ms, p_ms, b_ms, b_by)}


def timings(dev, card_tag) -> dict:
    """{(storage, mode): (kernel ms, plain ms, bound ms, bound by)}; a
    bfloat16 mode also ``mode + ":one_site"``, the one-site kernel's time
    on the same operands."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_one_site, dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(LARGE, dev, seed=2)
    a_pk = clover_blocks_of(gauges["f64"], lat, CL_KAPPA, CL_CSW)[1]   # at the output parity
    sites = lat.half_volume
    dims = "x".join(map(str, LARGE))
    out = {}
    for name, dt, rows, _ in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        cl = a_pk.to(dt).contiguous()
        # bfloat16: the MG smoother's two launches, twist_inv and xpay_full
        modes = {"f32": MODES, "f64": MODES[:1] + MODES[3:]}.get(name, MODES[1:2] + MODES[3:])
        for mode, epi, scale in modes + CLOVER_MODES[:2]:
            xpay, clover = epi.endswith("xpay"), epi.startswith("clover")
            kw = dict(epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      psi0=psi0 if xpay else None, clover=cl if clover else None)
            k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, **kw), reps=50)
            p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, **kw), reps=1, warmup=1)
            flops = (FLOP_PER_SITE + (CLOVER_FLOP_PER_SITE if clover else 0)) * sites
            naive, comp = (b * sites for b in bytes_per_site(dt, rows, xpay, clover))
            b_ms, b_by = bound(comp, flops, dt)
            print(f"  {dims} {name} recon-{rows * 6} {mode:11s} kernel {k_ms:.4f} ms "
                  f"({flops / (k_ms * 1e-3) / 1e9:.1f} GFLOP/s; effective "
                  f"{naive / (k_ms * 1e-3) / 1e9:.1f} GB/s naive, "
                  f"{comp / (k_ms * 1e-3) / 1e9:.1f} GB/s compulsory = "
                  f"{comp / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
                  f"{b_ms:.4f} ms by {b_by}) | plain {p_ms:.3f} ms | {card_tag}")
            out[(name, mode)] = (k_ms, p_ms, b_ms, b_by)
            if name == "bf16":
                out.update(one_site_beside(
                    f"  {dims} bf16 recon-12 {mode:11s}", (name, mode), out[(name, mode)],
                    lambda: dslash_eo(u, psi, 0, lat, **kw),
                    lambda: dslash_eo_one_site(u, psi, 0, lat, **kw), card_tag))
    # legs_out (f32, reconstruct-12, the probing operand): one spinor and 8
    # links read, 8 spinors written per output site, 8 legs without the sum
    u, psi = gauges["f32"], psi64.float()
    k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, legs_out=True), reps=50)
    p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, legs_out=True), reps=1, warmup=1)
    byts = (96 + 8 * 48 + 8 * 96) * sites
    b_ms, b_by = bound(byts, (FLOP_PER_SITE - 7 * 24) * sites, torch.float32)
    print(f"  {dims} f32 recon-12 legs_out kernel {k_ms:.4f} ms "
          f"({byts / 1e9:.2f} GB compulsory, {byts / (k_ms * 1e-3) / 1e9:.1f} GB/s = "
          f"{byts / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
          f"{b_ms:.4f} ms by {b_by}) | plain {p_ms:.3f} ms | {card_tag}")
    out[("f32", "legs_out")] = (k_ms, p_ms, b_ms, b_by)
    # one dirs leg (the per-leg probing path): one spinor, one link, one store
    k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, dirs=((3, +1),)), reps=50)
    p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, dirs=((3, +1),)), reps=1, warmup=1)
    b_ms, b_by = bound((96 + 48 + 96) * sites, FLOP_PER_SITE // 8 * sites, torch.float32)
    print(f"  {dims} f32 recon-12 dirs (t, +1) kernel {k_ms:.4f} ms (bound {b_ms:.4f} ms by "
          f"{b_by}) | plain {p_ms:.3f} ms | {card_tag}")
    out[("f32", "dirs")] = (k_ms, p_ms, b_ms, b_by)
    out.update(halo_timings(dev, card_tag))
    return out


def halo_timings(dev, card_tag) -> dict:
    """Halo mode, epilogue none, half-spinor faces, per launch: on the
    one-rank mesh at 32^3x64 (4f's shape; faces the own boundary slices)
    and at the (2, 2) shard size (32^2 x 16 x 32), beside the plain hop on
    the same local volume.  The bound reads the spinor, the links and the
    faces (12 reals a face site, the face links) once and writes the
    output once; bfloat16 with the one-site kernel beside the pair kernel.
    On the one-rank mesh also one float32 dirs leg, (t, +1), in halo mode.
    Returns {(storage, "halo_none" | "halo_none_2x2" | "none_2x2", and for
    bfloat16 the first two with ":one_site"; float32 "halo_dirs"): (kernel
    ms, plain ms, bound ms, bound by)}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_one_site, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, _ = problem(LARGE, dev, seed=7)
    out = {}
    for name, dt, rows, _ in HALO_STORAGE:
        u = (gauges["f64"] if rows == 3 else gauges["f32"]).to(dt).contiguous()
        psi = psi64.to(dt)
        item = psi.element_size()
        for grid, tag in (((1, 1), "halo_none"), ((2, 2), "halo_none_2x2")):
            m = LatticeMesh(lat, *grid, 1, 0)
            ul, pl, halo = cut_halo(m, u, psi, 0)
            llat = m.local_lat
            T, Z, S = llat.site_shape
            sites = llat.half_volume
            k_ms = time_ms(lambda: dslash_eo(ul, pl, 0, llat, halo=halo), reps=50)
            p_ms = time_ms(lambda: dslash_eo_plain(ul, pl, 0, llat, halo=halo), reps=1, warmup=1)
            faces = sum(x.numel() for x in halo[:6]) * item
            byts = (24 + 8 * rows * 6 + 24) * item * sites + faces
            b_ms, b_by = bound(byts, FLOP_PER_SITE * sites, dt)
            out[(name, tag)] = (k_ms, p_ms, b_ms, b_by)
            line = (f"  {'x'.join(map(str, llat.dims))} {name} recon-{rows * 6} halo none "
                    f"(grid {grid}) kernel {k_ms:.4f} ms ({byts / (k_ms * 1e-3) / 1e9:.1f} GB/s "
                    f"compulsory with {faces / 1e6:.2f} MB of faces = "
                    f"{byts / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
                    f"{b_ms:.4f} ms by {b_by}) | plain {p_ms:.3f} ms")
            if grid == (1, 1) and name == "f32":
                # one dirs leg in halo mode (K6 x K4, the sharded per-leg probing):
                # the t+1 neighbour (the face at the edge), one link, one store
                d_ms = time_ms(lambda: dslash_eo(ul, pl, 0, llat, halo=halo, dirs=((3, +1),)),
                               reps=50)
                dp_ms = time_ms(lambda: dslash_eo_plain(ul, pl, 0, llat, halo=halo,
                                                        dirs=((3, +1),)), reps=1, warmup=0)
                d_b, d_by = bound((24 + rows * 6 + 24) * item * sites, FLOP_PER_SITE // 8 * sites,
                                  dt)
                out[(name, "halo_dirs")] = (d_ms, dp_ms, d_b, d_by)
                print(f"  {'x'.join(map(str, llat.dims))} f32 recon-12 halo dirs (t, +1) (grid "
                      f"{grid}) kernel {d_ms:.4f} ms (bound {d_b:.4f} ms by {d_by}, "
                      f"{d_b / d_ms:.1%}) | plain {dp_ms:.3f} ms | {card_tag}")
            if grid != (1, 1):
                # K1 none on the same local volume, periodic in the shard
                n_ms = time_ms(lambda: dslash_eo(ul, pl, 0, llat), reps=50)
                out[(name, "none_2x2")] = (n_ms, None, None, None)
                line += f" | K1 none on the shard {n_ms:.4f} ms"
            print(line + f" | {card_tag}")
            if name == "bf16":
                out.update(one_site_beside(
                    f"  {'x'.join(map(str, llat.dims))} bf16 recon-12 halo none (grid {grid})",
                    (name, tag), out[(name, tag)], lambda: dslash_eo(ul, pl, 0, llat, halo=halo),
                    lambda: dslash_eo_one_site(ul, pl, 0, llat, halo=halo), card_tag))
    return out


#: the epilogues of the sharded operators' hops, timed on a mesh
MESH_TIMED = ("twist_inv", "xpay", "clover_inv", "clover_xpay")


def mesh_timings(dev, card_tag) -> dict:
    """The hops of the sharded operators at 32^3x64, per launch, float32 and
    bfloat16 reconstruct-12 and float64 18-real: halo mode (K6, half-spinor
    faces) with each epilogue of MESH_TIMED on the one-rank mesh (the
    whole lattice, 4o's and 4p's shape) and at the (2, 2) shard size; the
    overlap engine (interior launch and slab repairs, the faces given as
    an exchange would leave them) with twist_inv and clover_inv at the
    (2, 2, 1) and (2, 1, 2) shard sizes beside its interior launch alone
    and, at (2, 2, 1), the fused launch on the same shard (the (2, 2)
    row).  The bound is
    the shard's hop: the spinor, the links, psi0 and the clover blocks
    where the epilogue reads them and the faces read once, the output
    written once; plain is the plain version of the same hop (halo mode),
    timed once.  bfloat16's halo rows have the one-site kernel on the same
    operands beside the pair kernel (``:one_site``).  Returns {(storage,
    tag): (ms, plain ms, bound ms, bound by)}, tags halo_<epi>,
    halo_<epi>_2x2, overlap_<epi>_<grid>, interior_<epi>_<grid>."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_one_site, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.overlap import dslash_overlap
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, psi064 = problem(LARGE, dev, seed=9)
    blocks = clover_operands(gauges["f64"], lat)
    out = {}
    for name, dt, rows, _ in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        item = psi.element_size()

        def bound_of(m, halo, epi):
            xpay, clover = epi.endswith("xpay"), epi.startswith("clover")
            sites = m.local_lat.half_volume
            faces = sum(x.numel() for x in halo[:6]) * item
            byts = bytes_per_site(dt, rows, xpay, clover)[1] * sites + faces
            flops = (FLOP_PER_SITE + (CLOVER_FLOP_PER_SITE if clover else 0)) * sites
            return bound(byts, flops, dt)

        for epi in MESH_TIMED:
            kw = _hop_kw(epi, None, 0, dt, psi0, blocks)
            for grid, tag in (((1, 1, 1), f"halo_{epi}"), ((2, 2, 1), f"halo_{epi}_2x2")):
                m = LatticeMesh(lat, *grid, 0)
                ul, pl, halo = cut_halo(m, u, psi, 0)
                loc = _local(m, kw)
                k_ms = time_ms(lambda: dslash_eo(ul, pl, 0, m.local_lat, halo=halo, **loc),
                               reps=50)
                p_ms = time_ms(lambda: dslash_eo_plain(ul, pl, 0, m.local_lat, halo=halo, **loc),
                               reps=1, warmup=0)
                out[(name, tag)] = (k_ms, p_ms, *bound_of(m, halo, epi))
                print(f"  {'x'.join(map(str, m.local_lat.dims))} {name} recon-{rows * 6} halo "
                      f"{epi:11s} (grid {grid[:2]}) kernel {k_ms:.4f} ms (bound "
                      f"{out[(name, tag)][2]:.4f} ms by {out[(name, tag)][3]}, "
                      f"{out[(name, tag)][2] / k_ms:.1%}) | plain {p_ms:.3f} ms | {card_tag}")
                if name == "bf16":
                    out.update(one_site_beside(
                        f"  {'x'.join(map(str, m.local_lat.dims))} bf16 recon-12 halo {epi:11s} "
                        f"(grid {grid[:2]})", (name, tag), out[(name, tag)],
                        lambda: dslash_eo(ul, pl, 0, m.local_lat, halo=halo, **loc),
                        lambda: dslash_eo_one_site(ul, pl, 0, m.local_lat, halo=halo, **loc),
                        card_tag))
            if epi not in ("twist_inv", "clover_inv"):
                continue
            for grid in OVERLAP_GRIDS:
                g = "".join(map(str, grid))
                m = LatticeMesh(lat, *grid, 0)
                ul, pl, halo = cut_halo(m, u, psi, 0)
                loc = _local(m, kw)
                o_ms = time_ms(lambda: dslash_overlap(ul, pl, 0, m, halo, **loc), reps=20)
                i_ms = time_ms(lambda: dslash_eo(ul, pl, 0, m.local_lat, **loc), reps=50)
                line = (f"  {'x'.join(map(str, m.local_lat.dims))} {name} recon-{rows * 6} "
                        f"overlap {epi:10s} (grid {grid}) interior + repairs {o_ms:.4f} ms, "
                        f"interior alone {i_ms:.4f} ms")
                b = bound_of(m, halo, epi)
                p_ms = None
                if grid[2] == 1:       # K6 (fused) on this shard: the halo_<epi>_2x2 row
                    line += f", fused launch {out[(name, f'halo_{epi}_2x2')][0]:.4f} ms"
                    p_ms = out[(name, f"halo_{epi}_2x2")][1]
                    line += f" | plain {p_ms:.3f} ms"
                out[(name, f"overlap_{epi}_{g}")] = (o_ms, p_ms, *b)
                out[(name, f"interior_{epi}_{g}")] = (i_ms, None, None, None)
                print(line + f" (bound {b[0]:.4f} ms by {b[1]}) | {card_tag}")
    return out


def profile_overlap(dev, card_tag) -> None:
    """Where an overlap hop's time goes: 10 hops of the overlap engine
    (dslash_overlap: the interior launch and the slab repairs, the faces
    given) under torch.profiler at 32^3x64 on the (2, 2, 1) and (2, 1, 2)
    shards, float32 reconstruct-12 clover_inv at 4c's action.  Prints the
    wall time of a hop, the card's busy time (the kernels' device time),
    (also timed without the profiler), the launches and host-to-card
    copies a hop, and the operators that take the host's time, by self
    CPU time."""
    from torch.profiler import ProfilerActivity, profile
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.overlap import dslash_overlap
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, _ = problem(LARGE, dev, seed=9)
    blocks = clover_operands(gauges["f64"], lat)
    kw = _hop_kw("clover_inv", None, 0, torch.float32, None, blocks)
    hops = 10

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    for grid in OVERLAP_GRIDS:
        m = LatticeMesh(lat, *grid, 0)
        ul, pl, halo = cut_halo(m, gauges["f32"], psi64.float(), 0)
        loc = _local(m, kw)
        plain_wall = time_ms(lambda: dslash_overlap(ul, pl, 0, m, halo, **loc), reps=20, warmup=3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(hops):
                dslash_overlap(ul, pl, 0, m, halo, **loc)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / hops * 1e3
        ev = prof.key_averages()
        busy = sum(dev_us(e) for e in ev) / hops / 1e3
        per = {e.key: e.count / hops for e in ev}
        launches = per.get("cudaLaunchKernel", 0) + per.get("cuLaunchKernel", 0)
        h2d = sum(c for k, c in per.items() if "HtoD" in k)
        busy_s = (f"{busy:.3f} ms ({busy / wall:.1%} of the wall time)" if busy > 0
                  else "not measured (the profiler saw no device time)")
        print(f"  overlap hop profile, f32 recon-12 clover_inv, grid {grid} "
              f"({'x'.join(map(str, m.local_lat.dims))}): {plain_wall:.3f} ms a hop, {wall:.3f} ms "
              f"under the profiler, card busy {busy_s}; {launches:.0f} kernel launches and {h2d:.0f} "
              f"host-to-card copies a hop {card_tag}")
        cpu_ops = sorted((e for e in ev if e.self_cpu_time_total > 0),
                         key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in cpu_ops[:12]:
            print(f"    {e.key[:44]:44s} {e.count / hops:6.1f} calls a hop, self CPU "
                  f"{e.self_cpu_time_total / hops / 1e3:.3f} ms, device {dev_us(e) / hops / 1e3:.3f} "
                  "ms a hop")
        del ul, pl, halo, loc
    torch.cuda.empty_cache()


def new_timings(dev, card_tag, widths) -> dict:
    """The modes of the two-point slice at 32^3x64, per launch: the batched
    launch at N = 1, 2, 4, 12 and every N of ``widths``, the numbers of
    columns the main paths launched (f32 xpay, bf16 and f64 xpay_full),
    each beside N single launches of its columns, and f32 twist_inv at
    the widest of ``widths`` (4h's); reconstruct-8 beside reconstruct-12
    and 18-real (f32 and f64, none and xpay), compute="bf16" beside
    float32 arithmetic, and the lockstep CG step.  The bound of a batch
    reads the links once for its N columns.  Returns {(storage, tag):
    (kernel ms, plain ms, bound ms, bound by)}."""
    from tpuqcd_torch.operators import PackedTMOperatorPC
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.solvers.cg import _cg_cycle_cols
    lat, gauges, _, _ = problem(LARGE, dev, seed=12)
    sites = lat.half_volume
    dims = "x".join(map(str, LARGE))
    gen = torch.Generator(device=dev).manual_seed(22)
    ns = sorted({1, 2, 4, 12, *widths})
    out = {}

    def fields(n, dt):
        shape = (n, 2, 4, 3, *lat.site_shape)
        return (torch.randn(shape, generator=gen, device=dev).to(dt),
                torch.randn(shape, generator=gen, device=dev).to(dt))

    def report(name, tag, label, k_ms, p_ms, byts, flops, dt):
        b_ms, b_by = bound(byts, flops, dt)
        print(f"  {dims} {label} kernel {k_ms:.4f} ms ({byts / (k_ms * 1e-3) / 1e9:.1f} GB/s "
              f"compulsory = {byts / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / k_ms:.1%} of it reached)"
              + (f" | plain {p_ms:.3f} ms" if p_ms is not None else "") + f" | {card_tag}")
        out[(name, tag)] = (k_ms, p_ms, b_ms, b_by)

    # the batch axis, beside N single launches of the same columns
    batched = [(name, m, n) for name, m in (("f32", MODES[2]), ("bf16", MODES[3]),
                                            ("f64", MODES[3])) for n in ns]
    batched.append(("f32", MODES[1], max(widths)))
    for name, (mode, epi, scale), n in batched:
        dt, rows = next((d, r) for n_, d, r, _ in STORAGE if n_ == name)
        u = gauges[name]
        item = u.element_size()
        xpay = epi == "xpay"
        psi, psi0 = fields(n, dt)
        kw = dict(epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale)
        kw_b = dict(kw, psi0=psi0 if xpay else None)
        k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, **kw_b), reps=20)
        s_ms = time_ms(lambda: [dslash_eo(u, psi[i], 0, lat, psi0=psi0[i] if xpay else None,
                                          **kw) for i in range(n)], reps=10)
        p_ms = (time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, **kw_b), reps=1, warmup=1)
                if n in widths else None)
        byts = (n * (3 if xpay else 2) * 24 + 8 * rows * 6) * item * sites
        report(name, f"{mode}_b{n}", f"{name} recon-{rows * 6} {mode} batch N={n:2d} "
               f"({k_ms / n:.4f} ms a column; {n} single launches {s_ms:.4f} ms, "
               f"{s_ms / k_ms:.2f}x the batch's time)", k_ms, p_ms, byts,
               FLOP_PER_SITE * sites * n, dt)
        del psi, psi0
    # reconstruct-8 beside reconstruct-12 and 18-real
    g8 = gauges8(gauges)
    for name in ("f32", "f64"):
        dt = gauges[name].dtype
        links = {8: g8[name], 12: gauges["f64"][:, :, :2].to(dt).contiguous(),
                 18: gauges["f64"].to(dt)}
        (psi,), (psi0,) = fields(1, dt)
        item = psi.element_size()
        for mode, epi, scale in (MODES[0], MODES[2]):
            xpay = epi == "xpay"
            for reals, u in links.items():
                kw = dict(epilogue=epi, kappa=KAPPA, mu=MU, psi0=psi0 if xpay else None)
                k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, **kw), reps=50)
                p_ms = (time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, **kw), reps=1, warmup=1)
                        if reals == 8 else None)
                byts = ((3 if xpay else 2) * 24 + 8 * reals) * item * sites
                report(name, f"{mode}_r{reals}", f"{name} {reals}-real links {mode}", k_ms, p_ms,
                       byts, FLOP_PER_SITE * sites, dt)
    # compute="bf16" beside bfloat16 storage with float32 arithmetic
    u = gauges["bf16"]
    (psi,), (psi0,) = fields(1, torch.bfloat16)
    for mode, epi, scale in (MODES[0], MODES[3]):
        xpay = epi == "xpay"
        kw = dict(epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale, psi0=psi0 if xpay else None)
        byts = ((3 if xpay else 2) * 24 + 8 * 12) * 2 * sites
        for compute in ("f32", "bf16"):
            k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, compute=compute, **kw), reps=50)
            p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, compute=compute, **kw),
                           reps=1, warmup=1)
            report("bf16", f"{mode}_c{compute}", f"bf16 recon-12 {mode} compute={compute}", k_ms,
                   p_ms, byts, FLOP_PER_SITE * sites, torch.bfloat16)
    # the lockstep CG step: the normal operator on N columns, 20 steps
    pc = PackedTMOperatorPC(lat, kappa=KAPPA, mu=MU)
    u = gauges["f32"]
    for n in ns:
        b, _ = fields(n, torch.float32)
        never = torch.zeros(n, dtype=torch.float64, device=dev)
        budget = torch.full((n,), 20, dtype=torch.int64, device=dev)
        live = torch.ones(n, dtype=torch.bool, device=dev)

        def steps():
            _cg_cycle_cols(lambda v: pc.normal(u, v), b, never, budget, live)

        ms = time_ms(steps, reps=1, warmup=1) / 20
        print(f"  {dims} lockstep CG step (f32 normal operator, 4 batched launches) N={n:2d}: "
              f"{ms:.3f} ms a step, {ms / n:.3f} ms a column | {card_tag}")
        out[("f32", f"cg_step_b{n}")] = (ms, None, None, None)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    try:
        import tpuqcd_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the tpuqcd_torch package is not importable here: {e}", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    have_h5py = subprocess.run([sys.executable, "-c", "import h5py"],
                               capture_output=True).returncode == 0

    say("phase 1: card")
    smi, name = card()
    card_tag = f"[{smi}]"
    print(f"  nvidia-smi: {smi}; torch: {name}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    say("phase 2: build, on a thread beside 4b's heatbath chain (which launches no kernel)")
    from tpuqcd_torch.ops.dslash_cuda import library
    t0, built = time.perf_counter(), {}

    def build_in_thread():
        try:
            library.get()
        except Exception as e:          # failed below, on the main thread
            built["error"] = e
    build_thread = threading.Thread(target=build_in_thread, name="build")
    build_thread.start()
    say(f"phase 4b: the gauge: a heatbath chain (beta {MG_BETA}, seed 0) of two members "
        f"written to ILDG, {MG_SWEEPS} sweeps to c0000 and {CHAIN_SKIP} more to c0001; c0000 "
        "read back")
    ens_dir = tempfile.mkdtemp(prefix="tpuqcd_ensemble_")
    atexit.register(shutil.rmtree, ens_dir, True)
    gauge, chain = chain_gauge(dev, ens_dir)
    build_thread.join()
    if "error" in built:
        fail(f"the kernel library did not build: {built['error']}")
    secs = build_report()
    print(f"  built tpuqcd_torch/csrc/ (13 translation units side by side, one link) in "
          f"{secs:.1f} s, beside the chain (phase 2 and 4b's chain together "
          f"{time.perf_counter() - t0:.1f} s); h5py "
          f"{'imports' if have_h5py else 'does not import'} here", flush=True)
    say("phase 4x, started: run_invert's main as one rank under torchrun over NCCL on a "
        f"heatbath chain of {CHAIN_RANK_MEMBERS} members at 32^3x64, beside phase 3")
    x_run = torchrun_chain_start(ens_dir)

    say("phase 3: kernel against plain version")
    compare(SMALL, dev)
    max_abs = compare(LARGE, dev)
    say("phase 3: leg modes (K4) against plain version")
    compare_legs(SMALL, dev)
    legs_abs, dirs_abs = compare_legs(LARGE, dev)
    say("phase 3: clover epilogues (K3) against plain version")
    compare_clover(SMALL, dev)
    clover_abs = compare_clover(LARGE, dev)
    say("phase 3: MG fine applies against plain version")
    compare_fine_apply(SMALL, dev)
    fine_abs = compare_fine_apply(LARGE, dev)
    compare_fine_apply(SMALL, dev, clover=True)
    fine_cl_abs = compare_fine_apply(LARGE, dev, clover=True)
    say("phase 3: halo mode (K6) on a one-rank mesh and an emulated (2, 2) decomposition, "
        "with the twisted-mass and the clover epilogues")
    compare_halo(SMALL, dev)
    halo_abs = compare_halo(LARGE, dev)
    say("phase 3: the bfloat16 pair kernel bit for bit against the one-site kernel on the "
        "same operands, and against the plain version")
    pair_abs = compare_pairs(LARGE, dev)
    say("phase 3: the overlap engine on emulated (2, 2, 1) and (2, 1, 2) meshes")
    compare_overlap(SMALL, dev)
    overlap_abs = compare_overlap(LARGE, dev)
    torch.cuda.empty_cache()
    r8_abs, bf16c_abs = new_compares(dev)

    say("phase 4a: main path, tpuqcd_torch.cli.run_invert (CG) at 32^3x64")
    res, counts = main_path(dev)
    say("phase 4o: 4a's solve at 16^3x32 on one card, then through solve_tm_sharded on a "
        "one-rank LatticeMesh, fused and overlap")
    mo_tm = mesh_direct_path(dev, main_path(dev, MID)[0])
    tm_x = res.x.cpu()
    res = slim(res)
    say("phase 4b: main path, tpuqcd_torch.cli.run_invert (MG) at 32^3x64")
    with solve_peak() as mg_peak:
        mg_res, mg_counts = mg_path(dev, gauge)
    say("phase 4b: the same coarse operator by per-leg probing")
    pl_counts = per_leg_probing(mg_res)
    say("phase 4i: four point-source columns in lockstep on 4b's hierarchy "
          "(solve_tm_mg_batch)")
    mgb_batch_s, mgb_single_s, _, mgb_counts = mg_batch_path(dev, mg_res.mg, gauge.u_pk)
    say("phase 4v: 4b's hierarchy with MG's bfloat16 solver buffers (mg.gcr_dtype, "
        "mg.vec_dtype): the twin built from the same null vectors, 4b's source solved")
    twin, v_built = mg_bf16_twin(mg_res.mg)
    mg_x = mg_res.x.cpu()
    mg_res = dataclasses.replace(mg_res, mg=None, x=None)
    torch.cuda.empty_cache()
    v_res, v_counts, v_seconds, v_peak = mg_bf16_path(dev, twin, mg_res, mg_peak, v_built)
    del v_res
    torch.cuda.empty_cache()
    say("phase 4w: the lockstep MG on 4v's twin at the width the memory check admits "
        "(solve_certified_batch): its first refinement's first GCR cycle")
    w_n, w_seconds, w_counts = lockstep_admitted_path(dev, twin, mg_res)
    del twin
    torch.cuda.empty_cache()
    mg_res = slim(mg_res)
    say(f"phase 4x: the same chain generated here ({CHAIN_RANK_SWEEPS} sweeps, skip "
        f"{CHAIN_RANK_SKIP}) beside the files of the rank started before phase 3")
    x_chain = torchrun_chain_finish(dev, ens_dir, x_run)
    say("phase 4r: main path, run_invert's mass sweep (examples/invert_musweep_32cube.yaml: "
        "multishift CG, every mass certified) on c0000 at 32^3x64, then four cold solves")
    sw_res, sw_counts, sw_cold_counts, sw_cold = musweep_path(dev, gauge, chain)
    torch.cuda.empty_cache()
    # the host-bound cells at 16^3x32 and 24^3x48 run before the cells whose
    # peaks reach 30-41 GiB (4j-4l): after those, host-bound work measured
    # 20-80% slower in the same process
    say("phase 4p: 4b's recipe at 16^3x32: the heatbath gauge, the MG solve on one card, then "
        "through the sharded fine level on a one-rank LatticeMesh")
    gauge_mid = heatbath_gauge(dev, MID)
    hb_mid_s = gauge_mid.seconds
    mp_twin, _ = mg_path(dev, gauge_mid, dims=MID)
    mp_twin = dataclasses.replace(mp_twin, mg=None)
    mp_setup_s, mp_solve_s, mp_counts, mp_mg, mp_res = mesh_mg_path(dev, mp_twin, gauge_mid)
    say("phase 4v: 4p's sharded hierarchy on the one-rank mesh with MG's bfloat16 solver "
        "buffers, 4p's source solved")
    vm_seconds, vm_counts = mesh_mg_bf16_path(dev, mp_mg, mp_res, mp_twin, gauge_mid)
    del mp_mg, mp_res
    mp_twin = slim(mp_twin)
    say("phase 4q: three columns through ShardedEigCGSolver on a one-rank LatticeMesh beside "
        "the one-card EigCGSolver at 16^3x32")
    mq_seconds, mq_counts, mq_one_s = mesh_eigcg_path(dev, gauge_mid)
    say("phase 4r: the mass sweep on a one-rank LatticeMesh beside one card at 16^3x32")
    swm_s, swm_one_s, swm_counts = musweep_mesh_path(dev, gauge_mid)
    say("phase 4t: run_threeptwop.measure on a one-rank LatticeMesh beside its one-card twin "
        "at 16^3x32 (4j's action and smearing, P5z, the proton, the source off the origin)")
    mt_counts, mt_stages, mt_one_stages, mt_s, mt_one_s = mesh_threep_path(dev, gauge_mid)
    say("phase 4u: run_loops.measure on a one-rank LatticeMesh beside its one-card twin at "
        "16^3x32 (4k's physics: TSM, Lanczos to eig_outfile, one-derivative loops; 4o's action)")
    mu_counts, mu_stages, mu_one_stages, mu_s, mu_one_s = mesh_loops_path(dev, gauge_mid)
    del gauge_mid
    torch.cuda.empty_cache()
    say("phase 4s: BASELINE config 3, the three-level MG of examples/invert_mg3_24cube.yaml "
        "at 24^3x48, then 4b's two-level recipe on the same gauge")
    (mg3_res, mg3_counts), (mg32_res, mg32_counts), hb3_s = mg3_path(dev)
    torch.cuda.empty_cache()
    say("phase 4c: main path, run_invert (twisted clover, BiCGStab bf16) at 32^3x64")
    cl_res, cl_counts = clover_path(dev)
    say("phase 4o: 4c's solve at 16^3x32 on one card, then through solve_tm_sharded on a "
        "one-rank LatticeMesh, fused and overlap")
    mo_cl = mesh_direct_path(dev, clover_path(dev, MID)[0], clover=True)
    say("phase 4d: main path, run_invert (twisted clover, MG) at 32^3x64")
    mgc_res, mgc_counts = mg_path(dev, gauge, clover=True)
    say("phase 4e: main path, run_invert (non-degenerate doublet, CG) at 32^3x64")
    nd_res, nd_counts = ndeg_path(dev)
    say("phase 4f: the doublet solve on a one-rank LatticeMesh (halo mode) at 32^3x64")
    sh_seconds, sh_counts = sharded_path(dev, nd_res)
    say("phase 4g: run_invert on a mesh of cards (torchrun, NCCL): the doublet, twisted mass "
        "fused, overlap and auto, MG")
    multi_card_path(nd_res.x.cpu(), tm_x, mg_x,
                    {"dims": list(LARGE), "config_file": chain["files"][0],
                     "plaquette_check": chain["plaquettes"][0]})
    del tm_x, mg_x
    nd_res, mgc_res, cl_res = slim(nd_res), slim(mgc_res), slim(cl_res)
    say("phase 4m: main path, run_twop over the ensemble gauge.config_files = [c0000, c0001] "
        "at 32^3x64, as its main loops it (member c0000 is cell 4h)")
    tw_res, tw_counts, ens_counts, ens_stats, ens_io = ensemble_path(
        dev, chain["files"], chain["plaquettes"], have_h5py)
    say("phase 4n: Landau gauge fixing of c0000 in setup_gauge on the card, and the "
        "gauge-invariant witness")
    gf_detail, gf_counts, gf_seconds = gauge_fix_path(dev, chain["files"][0], gauge)
    torch.cuda.empty_cache()
    tw_seconds = tw_res.seconds
    tw_proton = tw_res.correlators["twop/proton/P+/sx0sy0sz0st0"]
    # the numbers of columns the batched launches of 4h, 4i and 4j had
    tw_widths = sorted({rec["columns"] for rec in tw_res.solves if rec["columns"] > 1})
    tw_n, tw_ns = max(tw_widths), ", ".join(map(str, tw_widths))
    del tw_res
    torch.cuda.empty_cache()
    say("phase 4j: main path, tpuqcd_torch.cli.run_threeptwop.measure (sequential sources, "
        "flavor-flipped batched backward solves, insertions) at 32^3x64")
    tj_res, tj_counts, tj_audit_s = threep_path(dev, gauge, tw_proton, have_h5py)
    tj_seconds = tj_res.seconds
    tj_widths = sorted({rec["columns"] for rec in tj_res.solves if rec["columns"] > 1})
    tj_n, tj_ns = max(tj_widths), ", ".join(map(str, tj_widths))
    del tj_res
    torch.cuda.empty_cache()
    say("phase 4k: main path, tpuqcd_torch.cli.run_loops.measure (Z4 noise, spin-colour "
        "dilution, TSM, Lanczos deflation, exact low modes, one-derivative loops) at 32^3x64")
    tk_res, tk_counts, tk_audit_s, tk_peak = loops_path(dev, gauge, have_h5py)
    tk_widths = sorted({rec["columns"] for rec in tk_res.solves if rec["columns"] > 1} | {12})
    tk_n, tk_ns = max(tk_widths), ", ".join(map(str, tk_widths))
    torch.cuda.empty_cache()
    say("phase 4l: the loop run with eigCG against the batched CG on the same noise at 32^3x64")
    tl_res, tl_counts, tl_cg_counts, tl_cg_seconds, tl_widths = eigcg_path(dev, gauge)
    tl_n, tl_ns = max(tl_widths), ", ".join(map(str, tl_widths))
    torch.cuda.empty_cache()
    widths = sorted({*tw_widths, *tj_widths, *tk_widths, *tl_widths, MGB_COLUMNS,
                     WITNESS_COLUMNS, w_n})
    say("phase 3: the batch axis at 32^3x64 with the numbers of columns 4h's, 4i's, 4j's, "
        f"4k's, 4l's, 4m's, 4n's and 4w's launches had, N = {', '.join(map(str, widths))}")
    batch_abs = compare_batch(LARGE, dev, widths)

    say(f"phase 5: times {card_tag}")
    t = timings(dev, card_tag)
    print(f"  CG solve: {res.seconds:.3f} s wallclock, {res.iters} sloppy matvecs, "
          f"{res.gflops:.1f} GFLOP/s (solve_flops accounting) {card_tag}")
    for what, r in (("MG solve", mg_res), ("clover MG solve", mgc_res)):
        print(f"  {what}: {r.seconds:.3f} s wallclock, {r.iters} inner iterations, "
              f"{r.refinements} refinements; setup {r.setup_seconds['mg_setup']:.2f} s "
              f"{card_tag}")
    print(f"  clover BiCGStab solve: {cl_res.seconds:.3f} s wallclock, {cl_res.iters} sloppy "
          f"matvecs, {cl_res.refinements} refinements; clover set-up "
          f"{cl_res.setup_seconds['clover']:.3f} s {card_tag}")
    print(f"  doublet CG solve: {nd_res.seconds:.3f} s wallclock, {nd_res.iters} sloppy "
          f"matvecs, {nd_res.refinements} refinements; on the one-rank mesh {sh_seconds:.3f} s "
          f"{card_tag}")
    say("phase 5: the batch axis, reconstruct-8, bfloat16 arithmetic, the lockstep CG step")
    t.update(new_timings(dev, card_tag, widths))
    say("phase 5: halo mode and the overlap engine at the one-rank mesh and the (2, 2) shard")
    t.update(mesh_timings(dev, card_tag))
    profile_overlap(dev, card_tag)
    say("phase 5: the main paths' seconds")
    for what, mo in (("twisted mass (4a's)", mo_tm), ("twisted clover (4c's)", mo_cl)):
        print(f"  {what} solve on a one-rank mesh at 16^3x32 (4o): fused {mo['fused'][0]:.3f} s, "
              f"overlap {mo['overlap'][0]:.3f} s {card_tag}")
    print(f"  MG on a one-rank mesh at 16^3x32 (4p): setup {mp_setup_s:.2f} s, solve "
          f"{mp_solve_s:.3f} s (one card: setup {mp_twin.setup_seconds['mg_setup']:.2f} s, solve "
          f"{mp_twin.seconds:.3f} s; the heatbath gauge {hb_mid_s:.2f} s) {card_tag}")
    print(f"  eigCG, 3 columns on a one-rank mesh at 16^3x32 (4q): {mq_seconds:.3f} s, on one "
          f"card {mq_one_s:.3f} s {card_tag}")
    print(f"  mass sweep (4r), 4 masses at 32^3x64: multishift {sw_res.iters} iterations, "
          f"sweep and certification {sw_res.seconds:.3f} s; four cold solves "
          f"{sum(c[2] for c in sw_cold):.3f} s ({sum(c[0] for c in sw_cold)} sloppy matvecs); "
          f"at 16^3x32 on a one-rank mesh {swm_s:.3f} s, one card {swm_one_s:.3f} s {card_tag}")
    print(f"  three-point run on a one-rank mesh at 16^3x32 (4t): {mt_s:.3f} s, one card "
          f"{mt_one_s:.3f} s (both with the audit); by stage, mesh / one card: "
          + ", ".join(f"{k} {v:.3f} / {mt_one_stages[k]:.3f}" for k, v in mt_stages.items())
          + f" {card_tag}")
    print(f"  loop run on a one-rank mesh at 16^3x32 (4u): {mu_s:.3f} s, one card "
          f"{mu_one_s:.3f} s (both with the audit); by stage, mesh / one card: "
          + ", ".join(f"{k} {v:.3f} / {mu_one_stages[k]:.3f}" for k, v in mu_stages.items())
          + f" {card_tag}")
    for what, r in (("three-level", mg3_res), ("two-level", mg32_res)):
        print(f"  MG at 24^3x48 (4s), {what}: setup {r.setup_seconds['mg_setup']:.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in r.setup_seconds.items()
                          if k[:-1] in ("nulls", "galerkin"))
              + f"), solve {r.seconds:.3f} s, {r.iters} inner iterations; the heatbath gauge "
              f"{hb3_s:.2f} s {card_tag}")
    tw_audit = next(iter(ens_stats.values()))[2]
    print("  two-point run (4h, member c0000 of 4m) seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in tw_seconds.items())
          + f"; net of the plain-operator audit (u {tw_audit[+1]:.3f} s, d "
          f"{tw_audit[-1]:.3f} s): solves_u {tw_seconds['solves_u'] - tw_audit[+1]:.3f}, "
          f"solves_d {tw_seconds['solves_d'] - tw_audit[-1]:.3f}; gauge is the ILDG take and "
          f"decode on the card {card_tag}")
    print("  three-point run (4j) seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in tj_seconds.items())
          + f" (the solves include the plain-operator audit, {tj_audit_s:.3f} s) {card_tag}")
    print("  loop run (4k) seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in tk_res.seconds.items())
          + f" (the solves include the plain-operator audit, {tk_audit_s:.3f} s); peak memory "
          f"{tk_peak:.2f} GiB {card_tag}")
    print("  loop run with eigCG (4l) seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in tl_res.seconds.items())
          + "; with the batched CG: "
          + ", ".join(f"{k} {v:.3f}" for k, v in tl_cg_seconds.items())
          + f" (both with the audit) {card_tag}")
    print(f"  MG, 4 point-source columns (4i): lockstep {mgb_batch_s:.2f} s, one by one "
          f"{mgb_single_s:.2f} s {card_tag}")
    print(f"  MG with bfloat16 solver buffers (4v) at 32^3x64: twin {v_built['build']:.2f} s, "
          f"solve {v_seconds:.3f} s (4b: {mg_res.seconds:.3f} s), peak {v_peak / 1e9:.3f} GB "
          f"(4b: {mg_peak['peak'] / 1e9:.3f} GB); restrict + prolong {v_built['bfloat16']:.3f} ms "
          f"(float32 bank {v_built['float32']:.3f} ms); on the one-rank mesh at 16^3x32 twin and "
          f"solve {vm_seconds:.3f} s {card_tag}")
    print(f"  lockstep MG at the admitted width (4w): {w_n} columns, one GCR cycle "
          f"{w_seconds:.2f} s; one rank under torchrun over NCCL (4x): its launch "
          f"{x_chain['rank']:.2f} s, the same chain here {x_chain['here']:.2f} s {card_tag}")
    print(f"  heatbath chain (4b): c0000 {MG_SWEEPS} compound sweeps {chain['sweeps'][0]:.3f} s, "
          f"c0001 {CHAIN_SKIP} more {chain['sweeps'][1]:.3f} s; "
          + "; ".join(io_line(f"write c000{i}", w) for i, w in enumerate(chain["writes"]))
          + "; " + io_line("read c0000 (4b)", chain["read"]) + f" {card_tag}")
    for ctag, (secs, det, audit_s) in ens_stats.items():
        print(f"  ensemble run (4m) member {ctag}: " + io_line("gauge", det) + "; seconds by "
              "stage: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
              + f" (the solves include the plain-operator audit, {sum(audit_s.values()):.3f} s) "
              f"{card_tag}")
    print(f"  read-ahead (4m): take(second member) host wait {ens_io['wait']:.3f} s; the same file "
          f"read synchronously: read {ens_io['sync']['read']:.3f} s, checksum "
          f"{ens_io['sync']['checksum']:.3f} s, decode {ens_io['sync']['decode']:.3f} s "
          f"{card_tag}")
    print(f"  gauge fixing (4n): {gf_detail['fix_sweeps']} landau sweeps "
          f"{gf_detail['fix_seconds']:.3f} s, functional {gf_detail['fix_initial']:.8f} -> "
          f"{gf_detail['fix_history'][-1]:.8f}; the witness' two batched solves "
          f"{gf_seconds:.3f} s {card_tag}")
    print(f"  smoke run {time.perf_counter() - t_start:.1f} s so far", flush=True)

    src = "tpuqcd_torch/csrc/dslash_eo.cuh"

    def entry(name, launches, err, timed, replaces="tpuqcd/ops/dslash_pallas.py:514"):
        k_ms, p_ms, b_ms, b_by = t[timed]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    nb = MGB_COLUMNS
    vmap = "tpuqcd/ops/dslash_pallas.py:733"   # the call jax.vmap adds a grid axis to
    k3 = "tpuqcd/ops/dslash_pallas.py:461"
    k6 = "tpuqcd/ops/dslash_pallas.py:583"
    kernels = [
        entry("dslash_eo<float> reconstruct-12 (CG sloppy operator), xpay timed",
              counts["float32"], max_abs["f32"], ("f32", "xpay")),
        entry("dslash_eo<double> 18-real (CG certification operator), xpay_full timed",
              counts["float64"], max_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 (MG fine operator), xpay_full timed",
              mg_counts["float32"], fine_abs["f32"], ("f32", "xpay_full")),
        entry("dslash_eo<bf16> pair reconstruct-12 (MG smoother), xpay_full timed",
              mg_counts["bfloat16"], fine_abs["bf16"], ("bf16", "xpay_full")),
        entry("dslash_eo<double> 18-real (MG certification operator), xpay_full timed",
              mg_counts["float64"], fine_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 legs_out (K4, MG Galerkin probing)",
              mg_counts["float32:legs_out"], legs_abs["f32"], ("f32", "legs_out")),
        entry("dslash_eo<bf16> pair reconstruct-12 clover_inv (K3, clover BiCGStab sloppy operator)",
              cl_counts["bfloat16:clover_inv"], clover_abs[("bf16", "clover_inv")],
              ("bf16", "clover_inv"), k3),
        entry("dslash_eo<bf16> pair reconstruct-12 clover_xpay (K3, clover BiCGStab sloppy operator)",
              cl_counts["bfloat16:clover_xpay"], clover_abs[("bf16", "clover_xpay")],
              ("bf16", "clover_xpay"), k3),
        entry("dslash_eo<double> 18-real clover_inv (K3, clover certification operator)",
              cl_counts["float64:clover_inv"], clover_abs[("f64", "clover_inv")],
              ("f64", "clover_inv"), k3),
        entry("dslash_eo<double> 18-real clover_xpay (K3, clover certification operator)",
              cl_counts["float64:clover_xpay"], clover_abs[("f64", "clover_xpay")],
              ("f64", "clover_xpay"), k3),
        entry("dslash_eo<float> reconstruct-12 clover_xpay (K3, MG fine clover operator)",
              mgc_counts["float32:clover_xpay"], fine_cl_abs["f32"], ("f32", "clover_xpay"), k3),
        entry("dslash_eo<bf16> pair reconstruct-12 clover_xpay (K3, MG clover smoother)",
              mgc_counts["bfloat16:clover_xpay"], fine_cl_abs["bf16"], ("bf16", "clover_xpay"),
              k3),
        entry("dslash_eo<double> 18-real clover_xpay (K3, MG clover certification operator)",
              mgc_counts["float64:clover_xpay"], fine_cl_abs["f64"], ("f64", "clover_xpay"), k3),
        entry("dslash_eo<float> reconstruct-12 dirs (K4, per-leg Galerkin probing), one leg timed",
              pl_counts["float32:dirs"], dirs_abs["f32"], ("f32", "dirs"),
              "tpuqcd/ops/dslash_pallas.py:428"),
        entry("dslash_eo<float> reconstruct-12 none (ndeg sloppy operator, per-flavor hop)",
              nd_counts["float32"], max_abs["f32"], ("f32", "none")),
        entry("dslash_eo<double> 18-real none (ndeg certification operator)",
              nd_counts["float64"], max_abs["f64"], ("f64", "none")),
        entry("dslash_eo<float> reconstruct-12 halo (K6, sharded ndeg sloppy operator), none "
              "timed on the one-rank mesh", sh_counts["float32:halo"], halo_abs["f32"],
              ("f32", "halo_none"), k6),
        entry("dslash_eo<double> 18-real halo (K6, sharded ndeg certification operator), none "
              "timed on the one-rank mesh", sh_counts["float64:halo"], halo_abs["f64"],
              ("f64", "halo_none"), k6),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (two-point sloppy operator, {tw_ns} "
              f"columns a launch), xpay N={tw_n} timed", tw_counts["float32:batch"],
              batch_abs[("f32", tw_n)], ("f32", f"xpay_b{tw_n}"), vmap),
        entry(f"dslash_eo<double> 18-real batch axis (two-point certification operator, {tw_ns} "
              f"columns a launch), xpay_full N={tw_n} timed", tw_counts["float64:batch"],
              batch_abs[("f64", tw_n)], ("f64", f"xpay_full_b{tw_n}"), vmap),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (ensemble run 4m: both members' "
              f"two-point sloppy operator, {tw_ns} columns a launch), xpay N={tw_n} timed",
              ens_counts["float32:batch"], batch_abs[("f32", tw_n)], ("f32", f"xpay_b{tw_n}"),
              vmap),
        entry(f"dslash_eo<double> 18-real batch axis (ensemble run 4m: both members' "
              f"certification, {tw_ns} columns a launch), xpay_full N={tw_n} timed",
              ens_counts["float64:batch"], batch_abs[("f64", tw_n)],
              ("f64", f"xpay_full_b{tw_n}"), vmap),
        entry("dslash_eo<float> reconstruct-12 (ensemble run 4m: the batch-gate probe columns), "
              "xpay timed", ens_counts["float32"], max_abs["f32"], ("f32", "xpay")),
        entry("dslash_eo<double> 18-real (ensemble run 4m: the probe columns' certification), "
              "xpay_full timed", ens_counts["float64"], max_abs["f64"], ("f64", "xpay_full")),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (gauge-fix witness 4n: batched CG, "
              f"{WITNESS_COLUMNS} columns), xpay N={WITNESS_COLUMNS} timed",
              gf_counts["float32:batch"], batch_abs[("f32", WITNESS_COLUMNS)],
              ("f32", f"xpay_b{WITNESS_COLUMNS}"), vmap),
        entry(f"dslash_eo<double> 18-real batch axis (gauge-fix witness 4n: certification, "
              f"{WITNESS_COLUMNS} columns), xpay_full N={WITNESS_COLUMNS} timed",
              gf_counts["float64:batch"], batch_abs[("f64", WITNESS_COLUMNS)],
              ("f64", f"xpay_full_b{WITNESS_COLUMNS}"), vmap),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (three-point sloppy operator, "
              f"forward and flavor-flipped backward solves, {tj_ns} columns a launch), xpay "
              f"N={tj_n} timed", tj_counts["float32:batch"], batch_abs[("f32", tj_n)],
              ("f32", f"xpay_b{tj_n}"), vmap),
        entry(f"dslash_eo<double> 18-real batch axis (three-point certification operator, "
              f"{tj_ns} columns a launch), xpay_full N={tj_n} timed", tj_counts["float64:batch"],
              batch_abs[("f64", tj_n)], ("f64", f"xpay_full_b{tj_n}"), vmap),
        entry("dslash_eo<float> reconstruct-12 (three-point batch-gate probe columns, sloppy), "
              "xpay timed", tj_counts["float32"], max_abs["f32"], ("f32", "xpay")),
        entry("dslash_eo<double> 18-real (three-point probe columns' certification), xpay_full "
              "timed", tj_counts["float64"], max_abs["f64"], ("f64", "xpay_full")),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (lockstep MG fine operator, {nb} "
              f"columns), xpay N={nb} timed", mgb_counts["float32:batch"],
              batch_abs[("f32", nb)], ("f32", f"xpay_b{nb}"), vmap),
        entry(f"dslash_eo<bf16> reconstruct-12 batch axis (lockstep MG smoother, {nb} columns), "
              f"xpay_full N={nb} timed", mgb_counts["bfloat16:batch"], batch_abs[("bf16", nb)],
              ("bf16", f"xpay_full_b{nb}"), vmap),
        entry(f"dslash_eo<double> 18-real batch axis (lockstep MG certification operator, {nb} "
              f"columns), xpay_full N={nb} timed", mgb_counts["float64:batch"],
              batch_abs[("f64", nb)], ("f64", f"xpay_full_b{nb}"), vmap),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (lockstep MG fine operator at the "
              f"admitted width 4w, {w_n} columns), xpay N={w_n} timed", w_counts["float32:batch"],
              batch_abs[("f32", w_n)], ("f32", f"xpay_b{w_n}"), vmap),
        entry(f"dslash_eo<bf16> reconstruct-12 batch axis (lockstep MG smoother 4w, {w_n} "
              f"columns), xpay_full N={w_n} timed", w_counts["bfloat16:batch"],
              batch_abs[("bf16", w_n)], ("bf16", f"xpay_full_b{w_n}"), vmap),
        entry(f"dslash_eo<double> 18-real batch axis (lockstep MG certification 4w, {w_n} "
              f"columns), xpay_full N={w_n} timed", w_counts["float64:batch"],
              batch_abs[("f64", w_n)], ("f64", f"xpay_full_b{w_n}"), vmap),
        entry(f"dslash_eo<float> reconstruct-12 batch axis (loop run 4k: dilution classes, "
              f"cheap TSM and low-mode solves, {tk_ns} columns a launch), xpay N={tk_n} timed",
              tk_counts["float32:batch"], batch_abs[("f32", tk_n)], ("f32", f"xpay_b{tk_n}"),
              vmap),
        entry(f"dslash_eo<double> 18-real batch axis (loop run 4k certification, {tk_ns} "
              f"columns a launch), xpay_full N={tk_n} timed", tk_counts["float64:batch"],
              batch_abs[("f64", tk_n)], ("f64", f"xpay_full_b{tk_n}"), vmap),
        entry("dslash_eo<float> reconstruct-12 (loop run 4k: Lanczos on M_d M_d^dag, probe "
              "columns), xpay_full timed", tk_counts["float32"], fine_abs["f32"],
              ("f32", "xpay_full")),
        entry("dslash_eo<double> 18-real (loop run 4k: probe columns' certification), "
              "xpay_full timed", tk_counts["float64"], max_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 (loop run 4l: eigCG's normal operator), xpay "
              "timed", tl_counts["float32"], max_abs["f32"], ("f32", "xpay")),
        entry("dslash_eo<double> 18-real (loop run 4l: eigCG's prepare, residuals and "
              "reconstruction), xpay_full timed", tl_counts["float64"], max_abs["f64"],
              ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 batch axis (loop run 4l, the batched CG beside "
              f"eigCG, {tl_ns} columns a launch), xpay N={tl_n} timed",
              tl_cg_counts["float32:batch"], batch_abs[("f32", tl_n)], ("f32", f"xpay_b{tl_n}"),
              vmap),
        entry(f"dslash_eo<double> 18-real batch axis (loop run 4l, the batched CG's "
              f"certification, {tl_ns} columns a launch), xpay_full N={tl_n} timed",
              tl_cg_counts["float64:batch"], batch_abs[("f64", tl_n)],
              ("f64", f"xpay_full_b{tl_n}"), vmap),
        # the sharded operators on a one-rank mesh at 16^3x32 (4o, 4p, 4q): halo
        # mode with every epilogue, and the overlap engine's interior launch
        entry("dslash_eo<float> reconstruct-12 halo twist_inv/xpay (K6 with K2, sharded "
              "twisted-mass sloppy operator 4o fused), xpay timed on the one-rank mesh",
              mo_tm["fused"][1]["float32:halo"], halo_abs["f32"], ("f32", "halo_xpay"), k6),
        entry("dslash_eo<double> 18-real halo twist_inv/xpay/none (K6 with K2, sharded "
              "certification 4o fused), xpay timed on the one-rank mesh",
              mo_tm["fused"][1]["float64:halo"], halo_abs["f64"], ("f64", "halo_xpay"), k6),
        entry("dslash_eo<bf16> pair reconstruct-12 halo clover_inv (K6 with K3, sharded clover "
              "BiCGStab sloppy operator 4o fused), timed on the one-rank mesh",
              mo_cl["fused"][1]["bfloat16:clover_inv:halo"], halo_abs[("bf16", "clover_inv")],
              ("bf16", "halo_clover_inv"), k6),
        entry("dslash_eo<bf16> pair reconstruct-12 halo clover_xpay (K6 with K3, sharded clover "
              "BiCGStab sloppy operator 4o fused), timed on the one-rank mesh",
              mo_cl["fused"][1]["bfloat16:clover_xpay:halo"], halo_abs[("bf16", "clover_xpay")],
              ("bf16", "halo_clover_xpay"), k6),
        entry("dslash_eo<double> 18-real halo clover_inv (K6 with K3, sharded clover "
              "certification 4o fused), timed on the one-rank mesh",
              mo_cl["fused"][1]["float64:clover_inv:halo"], halo_abs[("f64", "clover_inv")],
              ("f64", "halo_clover_inv"), k6),
        entry("dslash_eo<double> 18-real halo clover_xpay (K6 with K3, sharded clover "
              "certification 4o fused), timed on the one-rank mesh",
              mo_cl["fused"][1]["float64:clover_xpay:halo"], halo_abs[("f64", "clover_xpay")],
              ("f64", "halo_clover_xpay"), k6),
        entry("dslash_eo<float> reconstruct-12 halo xpay_full (K6 with K2, sharded MG fine "
              "operator 4p), xpay timed on the one-rank mesh", mp_counts["float32:halo"],
              halo_abs["f32"], ("f32", "halo_xpay"), k6),
        entry("dslash_eo<bf16> pair reconstruct-12 halo xpay_full (K6 with K2, sharded MG smoother "
              "4p), xpay timed on the one-rank mesh", mp_counts["bfloat16:halo"],
              halo_abs["bf16"], ("bf16", "halo_xpay"), k6),
        entry("dslash_eo<double> 18-real halo xpay_full (K6 with K2, sharded MG certification "
              "4p), xpay timed on the one-rank mesh", mp_counts["float64:halo"],
              halo_abs["f64"], ("f64", "halo_xpay"), k6),
        entry("dslash_eo<float> reconstruct-12 halo dirs (K6 with K4, sharded MG Galerkin "
              "probing 4p, one leg a launch), one dirs leg (t, +1) timed on the one-rank mesh",
              mp_counts["float32:dirs:halo"], dirs_abs["f32"], ("f32", "halo_dirs"),
              "tpuqcd/ops/dslash_pallas.py:428"),
        # MG with bfloat16 solver buffers (4v): the twin's probing and its solve, on
        # one card at 32^3x64 and on the one-rank mesh at 16^3x32
        entry("dslash_eo<float> reconstruct-12 (MG fine operator, bfloat16 GCR basis and "
              "null-vector bank 4v), xpay_full timed", v_counts["float32"], fine_abs["f32"],
              ("f32", "xpay_full")),
        entry("dslash_eo<bf16> pair reconstruct-12 (MG smoother 4v), xpay_full timed",
              v_counts["bfloat16"], fine_abs["bf16"], ("bf16", "xpay_full")),
        entry("dslash_eo<double> 18-real (MG certification operator 4v), xpay_full timed",
              v_counts["float64"], fine_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 legs_out (K4, the Galerkin probing of 4v's "
              "bfloat16 bank)", v_counts["float32:legs_out"], legs_abs["f32"],
              ("f32", "legs_out")),
        entry("dslash_eo<float> reconstruct-12 halo xpay_full (K6 with K2, sharded MG fine "
              "operator 4v), xpay timed on the one-rank mesh", vm_counts["float32:halo"],
              halo_abs["f32"], ("f32", "halo_xpay"), k6),
        entry("dslash_eo<bf16> pair reconstruct-12 halo xpay_full (K6 with K2, sharded MG smoother "
              "4v), xpay timed on the one-rank mesh", vm_counts["bfloat16:halo"],
              halo_abs["bf16"], ("bf16", "halo_xpay"), k6),
        entry("dslash_eo<double> 18-real halo xpay_full (K6 with K2, sharded MG certification "
              "4v), xpay timed on the one-rank mesh", vm_counts["float64:halo"],
              halo_abs["f64"], ("f64", "halo_xpay"), k6),
        entry("dslash_eo<float> reconstruct-12 halo dirs (K6 with K4, the sharded probing of 4v's "
              "bfloat16 bank, one leg a launch), one dirs leg (t, +1) timed on the one-rank mesh",
              vm_counts["float32:dirs:halo"], dirs_abs["f32"], ("f32", "halo_dirs"),
              "tpuqcd/ops/dslash_pallas.py:428"),
        entry("dslash_eo<float> reconstruct-12 halo twist_inv/xpay (K6 with K2, sharded eigCG "
              "normal operator 4q), xpay timed on the one-rank mesh", mq_counts["float32:halo"],
              halo_abs["f32"], ("f32", "halo_xpay"), k6),
        entry("dslash_eo<double> 18-real halo (K6, sharded eigCG prepare, residuals and "
              "reconstruction 4q), xpay timed on the one-rank mesh", mq_counts["float64:halo"],
              halo_abs["f64"], ("f64", "halo_xpay"), k6),
        # the mass sweep (4r): the multishift normal operator and x_i = g5 M(-mu) g5 y_i on
        # the MG view (xpay_full), the certification's twist_inv/xpay, the float64
        # residuals; on the one-rank mesh at 16^3x32 the same in halo mode
        entry("dslash_eo<float> reconstruct-12 (mass sweep 4r: multishift M_W M_W^dag and "
              "x_i = g5 M(-mu_i) g5 y_i, xpay_full; each mass's certification, twist_inv/xpay), "
              "xpay_full timed", sw_counts["float32"], fine_abs["f32"], ("f32", "xpay_full")),
        entry("dslash_eo<double> 18-real (mass sweep 4r: the stage's and the certification's "
              "residuals, prepare and reconstruction), xpay_full timed", sw_counts["float64"],
              max_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 (4r's four cold solve_tm beside the sweep), xpay "
              "timed", sw_cold_counts["float32"], max_abs["f32"], ("f32", "xpay")),
        entry("dslash_eo<double> 18-real (4r's cold solves' certification), xpay_full timed",
              sw_cold_counts["float64"], max_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 halo (K6 with K2, the mass sweep on a one-rank "
              "mesh at 16^3x32: sharded fine level and certification), xpay timed on the "
              "one-rank mesh", swm_counts["float32:halo"], halo_abs["f32"], ("f32", "halo_xpay"),
              k6),
        entry("dslash_eo<double> 18-real halo (K6, the sharded sweep's float64 residuals and "
              "certification at 16^3x32), xpay timed on the one-rank mesh",
              swm_counts["float64:halo"], halo_abs["f64"], ("f64", "halo_xpay"), k6),
        # the three-point run on a one-rank mesh at 16^3x32 (4t)
        entry("dslash_eo<float> reconstruct-12 halo twist_inv/xpay (K6 with K2, the three-point "
              "run on a one-rank mesh 4t: forward and backward columns one at a time), xpay "
              "timed on the one-rank mesh", mt_counts["float32:halo"], halo_abs["f32"],
              ("f32", "halo_xpay"), k6),
        entry("dslash_eo<double> 18-real halo (K6, 4t's sharded certification), xpay timed on "
              "the one-rank mesh", mt_counts["float64:halo"], halo_abs["f64"],
              ("f64", "halo_xpay"), k6),
        # the loop run on a one-rank mesh at 16^3x32 (4u)
        entry("dslash_eo<float> reconstruct-12 halo (K6 with K2, the loop run on a one-rank "
              "mesh 4u: Lanczos on M_d M_d^dag, xpay_full; full, low-mode and truncated TSM "
              "columns one at a time, twist_inv/xpay), xpay timed on the one-rank mesh",
              mu_counts["float32:halo"], halo_abs["f32"], ("f32", "halo_xpay"), k6),
        entry("dslash_eo<double> 18-real halo (K6, 4u's sharded certification and the "
              "truncated solves' residuals), xpay timed on the one-rank mesh",
              mu_counts["float64:halo"], halo_abs["f64"], ("f64", "halo_xpay"), k6),
        # three-level MG at 24^3x48 (4s), and 4b's two-level recipe beside it
        entry("dslash_eo<float> reconstruct-12 (three-level MG 4s at 24^3x48: fine operator, "
              "null vectors), xpay_full timed", mg3_counts["float32"], fine_abs["f32"],
              ("f32", "xpay_full")),
        entry("dslash_eo<bf16> pair reconstruct-12 (three-level MG 4s: fine smoother), "
              "xpay_full timed", mg3_counts["bfloat16"], fine_abs["bf16"], ("bf16", "xpay_full")),
        entry("dslash_eo<double> 18-real (three-level MG 4s: certification), xpay_full timed",
              mg3_counts["float64"], fine_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 legs_out (K4, three-level MG 4s: fine Galerkin "
              "probing)", mg3_counts["float32:legs_out"], legs_abs["f32"], ("f32", "legs_out")),
        entry("dslash_eo<float> reconstruct-12 (two-level MG at 24^3x48 beside 4s: fine "
              "operator), xpay_full timed", mg32_counts["float32"], fine_abs["f32"],
              ("f32", "xpay_full")),
        entry("dslash_eo<bf16> pair reconstruct-12 (two-level MG at 24^3x48: smoother), "
              "xpay_full timed", mg32_counts["bfloat16"], fine_abs["bf16"],
              ("bf16", "xpay_full")),
        entry("dslash_eo<double> 18-real (two-level MG at 24^3x48: certification), xpay_full "
              "timed", mg32_counts["float64"], fine_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 legs_out (K4, two-level MG at 24^3x48: Galerkin "
              "probing)", mg32_counts["float32:legs_out"], legs_abs["f32"], ("f32", "legs_out")),
        entry("dslash_eo<float> reconstruct-12 overlap interior + slab repairs "
              "(parallel/overlap.py; sharded twisted-mass sloppy operator 4o overlap, interior "
              "launches on one rank), twist_inv timed at the (2, 2, 1) shard",
              mo_tm["overlap"][1]["float32"], overlap_abs["f32"],
              ("f32", "overlap_twist_inv_221"), "tpuqcd/parallel/overlap.py:181"),
        entry("dslash_eo<double> 18-real overlap interior + slab repairs (sharded "
              "certification 4o overlap), twist_inv timed at the (2, 2, 1) shard",
              mo_tm["overlap"][1]["float64"], overlap_abs["f64"],
              ("f64", "overlap_twist_inv_221"), "tpuqcd/parallel/overlap.py:181"),
        entry("dslash_eo<bf16> pair reconstruct-12 overlap interior + slab repairs, clover_inv "
              "(sharded clover sloppy operator 4o overlap), timed at the (2, 2, 1) shard",
              mo_cl["overlap"][1]["bfloat16:clover_inv"], overlap_abs["bf16"],
              ("bf16", "overlap_clover_inv_221"), "tpuqcd/parallel/overlap.py:181"),
        entry("dslash_eo<double> 18-real overlap interior + slab repairs, clover_inv "
              "(sharded clover certification 4o overlap), timed at the (2, 2, 1) shard",
              mo_cl["overlap"][1]["float64:clover_inv"], overlap_abs["f64"],
              ("f64", "overlap_clover_inv_221"), "tpuqcd/parallel/overlap.py:181"),
        # on no path, in tpuqcd as here: held in phase 3, timed in phase 5
        entry("dslash_eo<float> reconstruct-8 (K5; no caller but dslash_eo, on no path), xpay "
              "timed", 0, r8_abs["f32"], ("f32", "xpay_r8"),
              "tpuqcd/ops/dslash_pallas.py:247"),
        entry("dslash_eo<bf16, compute bf16> pair reconstruct-12 (no caller but dslash_eo, on no "
              "path), xpay_full timed", 0, bf16c_abs, ("bf16", "xpay_full_cbf16"),
              "tpuqcd/ops/dslash_pallas.py:705"),
    ]
    # the one-site bfloat16 kernel: the shapes pair_sites refuses, on no main path
    path_counts = [counts, mg_counts, pl_counts, mgb_counts, v_counts, w_counts, mp_counts,
                   vm_counts,
                   cl_counts, mgc_counts,
                   nd_counts, sh_counts, tw_counts, ens_counts, gf_counts, tj_counts, tk_counts,
                   tl_counts, tl_cg_counts, mq_counts, sw_counts, sw_cold_counts, swm_counts,
                   mt_counts, mu_counts, mg3_counts, mg32_counts,
                   *(mo[policy][1] for mo in (mo_tm, mo_cl) for policy in ("fused", "overlap"))]
    kernels.append(entry(
        "dslash_eo<bf16> one-site reconstruct-12 (the shapes ops/dslash_cuda.pair_sites refuses: "
        "Xh odd, a misaligned view; on no main path), xpay_full timed on the pair row's operands",
        sum(v for c in path_counts for k, v in c.items() if k.endswith(":one_site")),
        pair_abs[("f32", "xpay_full")], ("bf16", "xpay_full:one_site")))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--invert-rank"]:
        invert_rank(sys.argv[2:])
    else:
        main()
