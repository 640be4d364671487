// Even-odd Wilson hop D_{q<-p} psi with the twisted-mass site-term
// epilogues, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpuqcd/ops/dslash_pallas.py::_kernel (launched
// by dslash_eo_pallas through the pl.pallas_call at :733), and in its
// double instantiation the XLA certification operator
// tpuqcd/ops/dslash_xla.py::dslash_eo_dev_ri.  Plain PyTorch version and
// binding: tpuqcd_torch/ops/dslash_cuda.py.
//
// What bounds it on the card: device-memory bandwidth.  The hop does 1320
// flop per output site; the naive traffic for float storage with
// reconstruct-12 links is about 1344 B per site (8 neighbour spinors of
// 96 B, 8 links of 48 B, the 96 B store, and the 96 B site-term read of
// the xpay epilogue), about 1 flop per byte, far below the H100's
// ~20 flop/byte ridge for fp32 outside the tensor cores.  Each spinor is a
// neighbour of 8 output sites, and the L1/L2 caches serve most of those
// re-reads, so the compulsory traffic is about 672 B per site (each
// spinor and link read once).  The design does what bandwidth asks:
//   - one thread per output site of parity q = 1 - p; the layouts keep
//     the site index minor ([2(ri), 4, 3, T, Z, S] spinors,
//     [4, 2, R, 3, 2(ri), T, Z, S] links), so every component load of a
//     warp is one coalesced line;
//   - reconstruct-12 rebuilds row 2 = phase * conj(row0 x row1) in
//     registers (phase = t_boundary on t-links at global t = T-1), which
//     cuts link traffic by a third;
//   - the 24 output reals accumulate in registers; the epilogue
//     (none | twist_inv | xpay | clover_inv | clover_xpay) is fused before
//     the single store, so one Schur-operator apply is exactly two launches;
//   - storage is templated (float, __nv_bfloat16 with float arithmetic,
//     double); the spin tables are compile-time constants.
// A Dslash has no product of tensor-core size.
//
// bfloat16 storage, the pair kernel.  The bf16 hop moves half the f32
// hop's bytes, but one thread a site reads every real with its own 2-byte
// load: as many memory instructions as f32, a warp's request 64 B where
// f32's is 128 B, twice the instructions and requests a byte (on an H100
// the one-site bf16 K2 reaches 53% of its bound, f32 71-73%; PERF.md
// §6).  The pair kernel (NS = 2) takes the
// output sites xh = 2k, 2k + 1 of one (t, z, y) row: they share t, z, y,
// o_p, the t phase and the halo edges, so every neighbour spinor, link,
// face, psi0 and clover entry of the y, z and t legs and of the epilogue
// is a run of two elements, read with one 4-byte __nv_bfloat162 load, and
// the store is one 4-byte store a component.  The x legs, one of which is
// off the pair's alignment in every row, read their spinors (and the
// backward leg its link) element by element.  An xpay pair issues 396
// memory instructions instead of 672.  The loads are split from the
// arithmetic (load_spinor, rebuild_link, hop_spinor, finish): each site of
// a pair runs the one-site code on values in registers, so the pair
// kernel gives the one-site kernel's bits (held on the card in every
// epilogue, dagger, parity, halo face and MG view).  Dispatch is by
// shape (ops/dslash_cuda.pair_sites, checked again in launch): bf16
// storage, one field, not legs_out, reconstruct-12 links, Xh even, every
// pointer 4-byte aligned and every re/im stride even; anything else runs
// the one-site kernel.  The pair kernel holds two accumulators (48 floats):
// 128 registers (166-168 in halo mode, where the face operands are chosen
// leg by leg), 4 (3) blocks of 128 threads a SM against the one-site
// kernel's 6 (5), no spills; it gains 10-16% a launch, not the 40% the
// instruction count promised, and what holds it there (occupancy, the x
// legs' element loads) is not settled (PERF.md §7).  Timed on the
// card and not kept (PERF.md, PR 11): 64 and 256 threads a block (no
// faster; 256 slower in halo mode), register caps through launch bounds
// (80-128 registers: spills, 5-60% slower), __ldg and streaming (__ldcs)
// link loads (no faster), and branching a halo leg between the face and
// the local field (fewer registers and faster at the one-rank mesh,
// slower at the (2, 2) shard, and with the clover epilogue slower than
// the one-site kernel).  The clover epilogue's two chiralities run as a
// loop in the halo pair kernel, the largest instantiation, where inline
// clover_inv timed a third slower.
//
// Leg filter and per-leg output (the TPU kernel's `dirs` and `legs_out`,
// dslash_pallas.py:341-354, :428-432, :670-680), for MG Galerkin probing:
//   - leg_mask: bit 2*mu + (sign < 0) selects the hop legs computed; the
//     8 legs are tested in the kernel's textual order (mu-major, forward
//     before backward), a uniform branch for the whole grid;
//   - legs_out: each selected leg's reconstructed contribution is stored
//     to its own output slot, in that textual order, right after it is
//     computed (the slot's 24 reals are the only extra registers), and no
//     epilogue runs.  A legs_out launch at 32^3x64 f32 recon-12 reads
//     about 480 B/site (one spinor and 8 links, compulsory) and writes
//     768 B/site (8 spinors), so it is store-bound where the summed hop is
//     read-bound.
// Clover epilogues (the TPU kernel's clover_inv and clover_xpay,
// dslash_pallas.py:461-501), for the twisted-clover operators: a clover
// operand cl [2(ri), 2(chir), 6, 6, T, Z, S] at the output parity (two
// Hermitian 6x6 blocks per site, row/column 3 * spin-in-chirality +
// colour; chirality c holds spins 2c, 2c + 1, gamma5 = +1, -1):
//   - clover_inv:  out = cl . D psi  (cl the twisted inverse
//     (A + i tw g5)^{-1}; one Schur apply is clover_inv then clover_xpay);
//   - clover_xpay: out = cl . psi0 + i tw g5 psi0 - k2 . D psi  (cl = A).
// The block is the largest operand per site (144 reals against the
// spinor's 24), every entry read once, coalesced (site index minor): a
// clover launch at 32^3x64 f32 recon-12 reads and writes about
// 1152 (clover_inv) or 1248 (clover_xpay) compulsory B/site, so it stays
// bandwidth-bound (about 2 flop per byte).  The design streams the
// block: per chirality the 6 inputs (D psi, or psi0) are held in
// registers and each output row is summed from 6 entries loaded just
// before use, so at most 12 extra reals are live beside the 24 of the
// accumulator.  CLOVER is a template flag, so the other modes compile as
// before.
// Halo mode (the TPU kernel's K6: halo_t, halo_z, local_dims and
// t_offset, dslash_pallas.py:522-528, :548-556, :565-616, :640-656), for
// one shard of a (t, z) decomposition: the launch's T and Z are the
// shard's, and a t or z leg that steps past the local edge reads a face
// operand instead of psi and u:
//   - spinor faces t-1, t+1 [2(ri), ns, 3, Z, S] and z-1, z+1
//     [2(ri), ns, 3, T, S], the neighbour shards' boundary slices; ns = 4
//     (full spinors) or 2 (half-spinors, already projected with this
//     launch's tables, so the leg skips its own projection);
//   - the mu=3 links of the t-1 face [R, 3, 2(ri), Z, S] and the mu=2
//     links of the z-1 face [R, 3, 2(ri), T, S], both of source parity p
//     (the only links a backward leg reads across an edge);
//   - t_offset, the shard's global t, and t_global, the global extent:
//     the reconstruct-12 phase goes on the rebuilt row at global t = T-1
//     (outside halo mode t_offset = 0 and t_global = T).
// The checkerboard uses local coordinates, which is right because every
// shard offset is even.  The faces add 2 x 12 (half) or 2 x 24 reals a
// boundary site, a surface term; HALO is a template flag, so the other
// modes keep their registers.
// Spinor operands may be views whose re/im planes are a stride apart
// (psi_rs, psi0_rs, out_rs: elements from the re to the im plane; 12*n
// when contiguous) and per-leg outputs a stride out_ls apart, so that
// the MG layout [2(ri), 2(par), 4, 3, T, Z, S] is read and written per
// parity in place.  Inside a plane the layout is [4, 3, T, Z, S].
//
// Batch axis (the TPU kernel under jax.vmap: the batching rule of the
// pl.pallas_call at dslash_pallas.py:733 adds a grid axis over the
// right-hand sides and reads the unbatched gauge once per program): psi,
// psi0 and out may hold n_batch fields psi_bs, psi0_bs and out_bs elements
// apart; u and the clover operand are shared.  n_batch > 1 runs
// dslash_eo_batch_kernel, whose compulsory traffic per site is the links
// once and the spinors per column: f32 reconstruct-12 xpay 384 + 288 N B,
// bf16 192 + 144 N, f64 18-real 1152 + 576 N.  A grid axis over the
// columns (blockIdx.y) would read and rebuild every link once per column,
// since the blocks of column 0 tend to run before those of column 1 and
// the links (384 MB at 32^3x64 f32) do not fit the 50 MB L2.  So:
//   - a block is a tile of 32 consecutive output sites (a warp's lanes)
//     times W column warps, 2 <= W <= 4 and 32 W threads, W chosen by
//     ops/dslash_cuda.batch_geometry and passed in with the tile's bytes,
//     which the launch checks against its own;
//   - phase 1: warp w reads and rebuilds legs w, w + W, ... of the tile's
//     sites into shared memory [leg][3][3][32 sites] of complex R (18 KB
//     for float, 36 KB for double, 9 KB for bfloat16 arithmetic; static,
//     under 48 KB), coalesced over the sites, an entry a 2-word access
//     without bank conflicts; its loads are unconditional, so a warp's
//     legs are in flight together; then __syncthreads;
//   - phase 2: warp w takes the columns w, w + W, ..., each with the
//     single kernel's leg (hop_leg) and epilogue (finish) code on the
//     shared links; spinor loads stay coalesced over the 32 sites;
//   - the tile order: where a t-slice streams more than a quarter of the
//     L2 (N spinors read, read by xpay and written, and the links: 58 MB
//     at 32^3x64 f32 N = 11), consecutive blocks take the same sites of 8
//     consecutive t-slices, so that a slice is still in the L2 when it is
//     read as the t-neighbour; in site order it would be read from device
//     memory up to three times a column.
// A batched launch equals its N single launches bit for bit: both rebuild
// a link with load_link (row 2 rounded step by step, so no contraction
// into a fused multiply-add differs between the two contexts) and apply
// it with the same hop_leg and finish.  The clover block (144 reals a site)
// is read per column: batched clover runs on no timed path, and a second
// tile would take f64 past 48 KB.  Not taken: tensor cores (a 3x3 complex
// product on 2N half-spinor columns, depth 3, about 1 flop per byte);
// cp.async/TMA double buffering of the next tile's links, since phase 1
// is a small part once its loads are in flight together; register caps
// (fewer registers spill), up to 8 column warps, two columns a warp on
// one shared link, and the legs without their leg-mask branches (ptxas
// then keeps every leg's loads in flight and runs out of registers): each
// was timed on the card and was slower or no faster.  What bounds it is
// the spinor traffic of each column, 8 neighbour spinors through L1/L2,
// as in the single kernel; the links are a 384/N B share.  N = 1 keeps
// the single kernel, which has no tile to fill.
// Reconstruct-8 (the TPU kernel's K5, dslash_pallas.py:247-303): NROW = 4
// reads 8 reals a link, [4(pair), 1, 2(ri)] = (u01, u02, (theta00, alpha),
// (beta, gamma)) of utils/packed.pack_gauge8: |u00| from the unit norm of
// row 0, row 1 = cos(a) e^{ib} v1 + sin(a) e^{ig} v2 in an orthonormal
// basis {v1, v2} of row 0's complement, row 2 as reconstruct-12.  v1
// pivots on the larger of |u01|^2, |u02|^2, compared with separately
// rounded products and sums (no fused multiply-add), which is bit for bit
// the comparison the packer and the plain version make on the stored
// values.  sincosf/sincos, never the fast intrinsics.
// Arithmetic types: S the storage, R the arithmetic of the projection,
// mat-vec, accumulation and epilogue, G that of the link reconstruction.
// R = float for float and __nv_bfloat16 storage, double for double; the
// TPU kernel's compute="bf16" (dslash_pallas.py:705-711) is S = R =
// __nv_bfloat16.  G = double for double storage, else float (a unitarity
// constraint needs more than 8 bits; dslash_pallas.py:312-327).
// One translation unit per (S, R, NROW), dslash_eo_inst.cu compiled with
// -DTQ_STORAGE, -DTQ_COMPUTE, -DTQ_NROW, -DTQ_NAME, all built side by side
// and linked with the entries of dslash_eo.cu.
//
// Spin-projection tables (DeGrand-Rossi; tpuqcd/gammas.py).  For
// (1 - gamma_mu):  h_a = psi_a + P(mu,a) psi_{partner(mu,a)},  a = 0, 1
//                  out_a = h_a,  out_b = Q(mu,b) h_{src(mu,b)},  b = 2, 3
// and (1 + gamma_mu) negates every P and Q.  P and Q are 0, +-1 or +-i.
// The daggered hop swaps the two projectors.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

// the arguments of a launch, shared by every entry point
#define TQ_PARAMS                                                                             \
  const void *u, const void *psi, const void *psi0, const void *clov, void *out, int T, int Z, \
      int Y, int Xh, int nrow, int src_parity, int dagger, int epilogue, double tw, double k2, \
      int t_boundary, int leg_mask, int legs_out, int64_t psi_rs, int64_t psi0_rs,            \
      int64_t out_rs, int64_t out_ls, int64_t psi_bs, int64_t psi0_bs, int64_t out_bs,        \
      int n_batch, int batch_warps, int batch_smem, int batch_t_block, const void *f_tm,      \
      const void *f_tp, const void *f_zm, const void *f_zp, const void *u_tm,                 \
      const void *u_zm, int halo, int face_spins, int t_offset, int t_global, int pair,      \
      int device, void *stream
#define TQ_ARGS                                                                               \
  u, psi, psi0, clov, out, T, Z, Y, Xh, nrow, src_parity, dagger, epilogue, tw, k2,           \
      t_boundary, leg_mask, legs_out, psi_rs, psi0_rs, out_rs, out_ls, psi_bs, psi0_bs,       \
      out_bs, n_batch, batch_warps, batch_smem, batch_t_block, f_tm, f_tp, f_zm, f_zp, u_tm,  \
      u_zm, halo, face_spins, t_offset, t_global, pair, device, stream

#ifndef TQ_NO_KERNELS  // dslash_eo.cu takes the argument lists only

namespace {

// the link-reconstruction arithmetic of a storage type
template <typename S> struct ReconOf { using type = float; };
template <> struct ReconOf<double> { using type = double; };

// value conversion between the storage and arithmetic types
template <typename To, typename From>
__device__ __forceinline__ To conv(From v) {
  if constexpr (std::is_same<To, From>::value) {
    return v;
  } else if constexpr (std::is_same<From, __nv_bfloat16>::value) {
    return To(__bfloat162float(v));
  } else if constexpr (std::is_same<To, __nv_bfloat16>::value) {
    return __float2bfloat16_rn((float)v);
  } else {
    return To(v);
  }
}

template <typename S, typename R>
__device__ __forceinline__ void store(S* p, R v) { *p = conv<S>(v); }

// math of the reconstruct-8 rebuild, float and double
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
__device__ __forceinline__ void sincos_(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sincos_(double a, double* s, double* c) { sincos(a, s, c); }
// x0^2 + x1^2 with each product and the sum rounded on its own
__device__ __forceinline__ float mag2(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}
__device__ __forceinline__ double mag2(double a, double b) {
  return __dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b));
}

// aligned as a pair, so that the batched kernel's shared link tile moves
// an entry with one 2-word access
template <typename R> struct alignas(2 * sizeof(R)) cpx { R re, im; };

template <typename R>
__device__ __forceinline__ cpx<R> cadd(cpx<R> a, cpx<R> b) { return {a.re + b.re, a.im + b.im}; }
template <typename R>
__device__ __forceinline__ cpx<R> cmul(cpx<R> a, cpx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename R>  // conj(a) * b
__device__ __forceinline__ cpx<R> cmulc(cpx<R> a, cpx<R> b) {
  return {a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re};
}

// (cr + i ci) * z for a table coefficient: exactly one of cr, ci is
// nonzero and it is +-1, known at compile time after unrolling
template <typename R>
__device__ __forceinline__ cpx<R> coef_mul(int cr, int ci, cpx<R> z) {
  if (cr != 0) return {cr > 0 ? z.re : -z.re, cr > 0 ? z.im : -z.im};
  return {ci > 0 ? -z.im : z.im, ci > 0 ? z.re : -z.re};
}

__host__ __device__ constexpr int partner(int mu, int a) { return mu < 2 ? 3 - a : 2 + a; }
__host__ __device__ constexpr int proj_re(int mu, int a) {
  return mu == 1 ? (a == 0 ? 1 : -1) : (mu == 3 ? -1 : 0);
}
__host__ __device__ constexpr int proj_im(int mu, int a) {
  return mu == 0 ? -1 : (mu == 2 ? (a == 0 ? -1 : 1) : 0);
}
__host__ __device__ constexpr int recon_src(int mu, int b) { return mu < 2 ? 3 - b : b - 2; }
__host__ __device__ constexpr int recon_re(int mu, int b) {
  return mu == 1 ? (b == 2 ? -1 : 1) : (mu == 3 ? -1 : 0);
}
__host__ __device__ constexpr int recon_im(int mu, int b) {
  return mu == 0 ? 1 : (mu == 2 ? (b == 2 ? 1 : -1) : 0);
}

// reals a stored link holds
__host__ __device__ constexpr int link_reals(int nrow) { return nrow == 4 ? 8 : nrow * 6; }

// Rows 0 and 1 of a reconstruct-8 link from its 8 stored reals
// (tpuqcd/ops/dslash_pallas.py:247-303, utils/packed.pack_gauge8).
template <typename G>
__device__ __forceinline__ void recon8_rows(const G (&x)[8], cpx<G> (&U)[3][3]) {
  const G m1 = mag2(x[0], x[1]), m2 = mag2(x[2], x[3]);
  const G a00sq = fmax(G(1) - (m1 + m2), G(0));
  const G a00 = sqrt_(a00sq);
  G s, c;
  sincos_(x[4], &s, &c);
  const cpx<G> u00 = {a00 * c, a00 * s}, u01 = {x[0], x[1]}, u02 = {x[2], x[3]};
  // the basis pivots on the larger of |u01|, |u02|: the packer's branch
  const bool use1 = m1 >= m2;
  const G inv = G(1) / sqrt_(fmax(a00sq + (use1 ? m1 : m2), G(1e-30)));
  const cpx<G> zero = {G(0), G(0)};
  cpx<G> v1[3], v2[3];
  v1[0] = use1 ? cpx<G>{-u01.re * inv, u01.im * inv} : cpx<G>{u02.re * inv, -u02.im * inv};
  v1[1] = use1 ? cpx<G>{u00.re * inv, -u00.im * inv} : zero;
  v1[2] = use1 ? zero : cpx<G>{-u00.re * inv, u00.im * inv};
  U[0][0] = u00, U[0][1] = u01, U[0][2] = u02;
#pragma unroll
  for (int j = 0; j < 3; ++j) {  // v2 = conj(row0 x v1)
    const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
    cpx<G> a = cmul(U[0][j1], v1[j2]);
    cpx<G> b = cmul(U[0][j2], v1[j1]);
    v2[j] = {a.re - b.re, -(a.im - b.im)};
  }
  G sa, ca, sb, cb, sg, cg;
  sincos_(x[5], &sa, &ca);
  sincos_(x[6], &sb, &cb);
  sincos_(x[7], &sg, &cg);
  const cpx<G> c1 = {ca * cb, ca * sb}, c2 = {sa * cg, sa * sg};
#pragma unroll
  for (int j = 0; j < 3; ++j) U[1][j] = cadd(cmul(c1, v1[j]), cmul(c2, v2[j]));
}

// products and differences rounded on their own: never contracted into a
// fused multiply-add, whatever the code around them
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// A stored link rebuilt to 3x3 in G (reconstruct-12 and -8: row 2 =
// phase * conj(row0 x row1)) and handed over in R, from its stored reals r
// in storage order.  Row 2 is rounded step by step (mul_rn, sub_rn), so a
// link rebuilt here has the same bits in the single kernel, which uses it
// at once, in the pair kernel, which rebuilds two sites' links one after
// the other, and in the batched one, which keeps it in shared memory for
// its columns.
template <int NROW, typename R, typename G>
__device__ __forceinline__ void rebuild_link(cpx<R> (&U)[3][3], const G (&r)[link_reals(NROW)],
                                             G phase) {
  cpx<G> Ug[3][3];
  if constexpr (NROW == 4) {
    recon8_rows(r, Ug);
  } else {
#pragma unroll
    for (int i = 0; i < NROW; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Ug[i][j] = {r[(i * 3 + j) * 2 + 0], r[(i * 3 + j) * 2 + 1]};
  }
  if constexpr (NROW != 3) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const cpx<G> x = Ug[0][j1], y = Ug[1][j2], v = Ug[0][j2], w = Ug[1][j1];
      const G are = sub_rn(mul_rn(x.re, y.re), mul_rn(x.im, y.im));
      const G aim = add_rn(mul_rn(x.re, y.im), mul_rn(x.im, y.re));
      const G bre = sub_rn(mul_rn(v.re, w.re), mul_rn(v.im, w.im));
      const G bim = add_rn(mul_rn(v.re, w.im), mul_rn(v.im, w.re));
      Ug[2][j] = {mul_rn(phase, sub_rn(are, bre)), mul_rn(-phase, sub_rn(aim, bim))};
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) U[i][j] = {conv<R>(Ug[i][j].re), conv<R>(Ug[i][j].im)};
}

// The link whose first element ul points at, elements u_ss apart, rebuilt
// (the batched kernel's phase 1).
template <int NROW, typename S, typename R, typename G>
__device__ __forceinline__ void load_link(cpx<R> (&U)[3][3], const S* __restrict__ ul,
                                          int64_t u_ss, G phase) {
  G x[link_reals(NROW)];
#pragma unroll
  for (int k = 0; k < link_reals(NROW); ++k) x[k] = conv<G>(ul[k * u_ss]);
  rebuild_link<NROW, R>(U, x, phase);
}

// NS elements as R: ld_run reads a run from p, v[j] = p[j] (NS = 2: one
// 4-byte __nv_bfloat162 load, p 4-byte aligned); ld_each reads one element
// from each of NS pointers anywhere, v[j] = p[j][off].
template <int NS, typename R, typename S>
__device__ __forceinline__ void ld_run(const S* __restrict__ p, R (&v)[NS]) {
  if constexpr (NS == 2) {
    static_assert(std::is_same<S, __nv_bfloat16>::value, "site pairs are bfloat16");
    const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = conv<R>(__low2bfloat16(w));
    v[1] = conv<R>(__high2bfloat16(w));
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) v[j] = conv<R>(p[j]);
  }
}
template <int NS, typename R, typename S>
__device__ __forceinline__ void ld_each(const S* const (&p)[NS], int64_t off, R (&v)[NS]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) v[j] = conv<R>(p[j][off]);
}
// v[j] stored to p[j], NS consecutive elements (NS = 2: one 4-byte store)
template <int NS, typename S, typename R>
__device__ __forceinline__ void st_run(S* __restrict__ p, const R (&v)[NS]) {
  if constexpr (NS == 2) {
    static_assert(std::is_same<S, __nv_bfloat16>::value, "site pairs are bfloat16");
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(conv<S>(v[0]), conv<S>(v[1]));
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) store(p + j, v[j]);
  }
}

// The operand of NS sites at one leg: site j's element at p[j]; RUN: the
// sites' elements are consecutive (p[j] = p[0] + j), and for NS = 2 p[0]
// is 4-byte aligned.
template <int NS, typename S> struct Sites { const S* p[NS]; };
template <int NS, typename S>
__device__ __forceinline__ Sites<NS, S> run(const S* p) {
  Sites<NS, S> r;
#pragma unroll
  for (int j = 0; j < NS; ++j) r.p[j] = p + j;
  return r;
}
template <int NS, bool RUN, typename R, typename S>
__device__ __forceinline__ void ld_sites(const Sites<NS, S>& a, int64_t off, R (&v)[NS]) {
  if constexpr (RUN) ld_run<NS>(a.p[0] + off, v);
  else ld_each<NS>(a.p, off, v);
}

// The neighbour spinors of NS sites: component (spin a, colour c) of site
// j at a.p[j] + (a * 3 + c) * ss, re/im rs apart; half: only the two
// projected spins are stored.
template <int NS, bool RUN, typename S, typename R>
__device__ __forceinline__ void load_spinor(cpx<R> (&s)[NS][4][3], const Sites<NS, S>& a,
                                            int64_t rs, int64_t ss, bool half) {
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) {
    if (sp >= 2 && half) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      R re[NS], im[NS];
      ld_sites<NS, RUN>(a, (sp * 3 + c) * ss, re);
      ld_sites<NS, RUN>(a, (sp * 3 + c) * ss + rs, im);
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][sp][c] = {re[j], im[j]};
    }
  }
}

// One hop leg on a neighbour spinor s already in registers: acc +=
// (1 -+ gamma_mu) U s, with U = the rebuilt link or (ADJ) its adjoint.
// sgn = +1 takes the (1 - gamma) tables, -1 the (1 + gamma); half: s
// holds the two projected spins (spins 2, 3 are not read).
template <int MU, bool ADJ, typename R>
__device__ __forceinline__ void hop_spinor(cpx<R> (&acc)[4][3], const cpx<R> (&s)[4][3],
                                           bool half, const cpx<R> (&U)[3][3], int sgn) {
  // half-spinor projection at the neighbour
  cpx<R> h[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int b = partner(MU, a);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const cpx<R> pa = s[a][c];
      if (half) {
        h[a][c] = pa;
        continue;
      }
      cpx<R> t = coef_mul(proj_re(MU, a), proj_im(MU, a), s[b][c]);
      h[a][c] = sgn > 0 ? cadd(pa, t) : cpx<R>{pa.re - t.re, pa.im - t.im};
    }
  }
  // SU(3) mat-vec on both half spinors, then reconstruct and accumulate
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    cpx<R> w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cpx<R> s_ = {conv<R>(0.f), conv<R>(0.f)};
#pragma unroll
      for (int j = 0; j < 3; ++j)
        s_ = cadd(s_, ADJ ? cmulc(U[j][i], h[a][j]) : cmul(U[i][j], h[a][j]));
      w[i] = s_;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[a][i] = cadd(acc[a][i], w[i]);
#pragma unroll
    for (int b = 2; b < 4; ++b) {
      if (recon_src(MU, b) != a) continue;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        cpx<R> t = coef_mul(recon_re(MU, b), recon_im(MU, b), w[i]);
        acc[b][i] = sgn > 0 ? cadd(acc[b][i], t)
                            : cpx<R>{acc[b][i].re - t.re, acc[b][i].im - t.im};
      }
    }
  }
}

// One hop leg of one site, the spinor read from psi (the batched kernel's
// phase 2): psi points at the neighbour's (spin 0, colour 0, re) element,
// spin-colour components psi_ss apart and re/im psi_rs apart.
template <int MU, bool ADJ, typename S, typename R>
__device__ __forceinline__ void hop_leg(cpx<R> (&acc)[4][3], const S* __restrict__ psi,
                                        int64_t psi_rs, int64_t psi_ss, bool half,
                                        const cpx<R> (&U)[3][3], int sgn) {
  cpx<R> s[1][4][3];
  load_spinor<1, true>(s, run<1>(psi), psi_rs, psi_ss, half);
  hop_spinor<MU, ADJ>(acc, s[0], half, U, sgn);
}

// One hop leg of NS sites (the single and the pair kernel): each site's
// neighbour spinor and stored link are read (RUN_S, RUN_U: as runs of
// consecutive elements), then the link is rebuilt and applied site by
// site with the one-site code, so a pair's sites get the bits one-site
// launches give them.
template <int NS, int NROW, int MU, bool ADJ, bool RUN_S, bool RUN_U, typename S, typename R,
          typename G>
__device__ __forceinline__ void leg(cpx<R> (&acc)[NS][4][3], const Sites<NS, S>& ps,
                                    int64_t psi_rs, int64_t psi_ss, bool half,
                                    const Sites<NS, S>& pu, int64_t u_ss, G phase, int sgn) {
  cpx<R> s[NS][4][3];
  load_spinor<NS, RUN_S>(s, ps, psi_rs, psi_ss, half);
  G x[NS][link_reals(NROW)];
#pragma unroll
  for (int k = 0; k < link_reals(NROW); ++k) {
    G v[NS];
    ld_sites<NS, RUN_U>(pu, k * u_ss, v);
#pragma unroll
    for (int j = 0; j < NS; ++j) x[j][k] = v[j];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    cpx<R> U[3][3];
    rebuild_link<NROW, R>(U, x[j], phase);
    hop_spinor<MU, ADJ>(acc[j], s[j], half, U, sgn);
  }
}

// Zero an accumulator.
template <typename R>
__device__ __forceinline__ void zero(cpx<R> (&acc)[4][3]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[a][c] = {conv<R>(0.f), conv<R>(0.f)};
}

// Store NS sites' spinors (24 reals each) at sites n, n + 1, ... of an
// output with re/im planes rs apart.
template <int NS, typename S, typename R>
__device__ __forceinline__ void store_spinor(S* __restrict__ out, int64_t rs, int64_t n_sites,
                                             int64_t n, const cpx<R> (&acc)[NS][4][3]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      S* o = out + (a * 3 + c) * n_sites + n;
      R re[NS], im[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) re[j] = acc[j][a][c].re, im[j] = acc[j][a][c].im;
      st_run<NS>(o, re);
      st_run<NS>(o + rs, im);
    }
}

// An output site n of parity q = 1 - p, for the batched kernel: its t and
// the flat indices of its 8 neighbours in the kernel's leg order (+x, -x,
// +y, -y, +z, -z, +t, -t), with periodic wrap and the even-odd x-shift
// rule (32-bit: launch refuses more than 2^31 - 1 sites a parity).
struct Hood {
  int t;
  int nb[8];
};

__device__ __forceinline__ Hood hood(int64_t n, int T, int Z, int Y, int Xh, int p) {
  Hood h;
  const int xh = (int)(n % Xh);
  const int y = (int)((n / Xh) % Y);
  const int z = (int)((n / ((int64_t)Xh * Y)) % Z);
  const int t = (int)(n / ((int64_t)Xh * Y * Z));
  h.t = t;
  auto site = [=](int t_, int z_, int y_, int xh_) -> int {
    return ((t_ * Z + z_) * Y + y_) * Xh + xh_;
  };
  // x offset of the source-parity rows (tpuqcd/ops/dslash_pallas.py:106)
  const bool o_p = ((t + z + y + p) & 1) == 1;
  h.nb[0] = site(t, z, y, o_p ? xh : (xh + 1 == Xh ? 0 : xh + 1));
  h.nb[1] = site(t, z, y, o_p ? (xh == 0 ? Xh - 1 : xh - 1) : xh);
  h.nb[2] = site(t, z, y + 1 == Y ? 0 : y + 1, xh);
  h.nb[3] = site(t, z, y == 0 ? Y - 1 : y - 1, xh);
  h.nb[4] = site(t, z + 1 == Z ? 0 : z + 1, y, xh);
  h.nb[5] = site(t, z == 0 ? Z - 1 : z - 1, y, xh);
  h.nb[6] = site(t + 1 == T ? 0 : t + 1, z, y, xh);
  h.nb[7] = site(t == 0 ? T - 1 : t - 1, z, y, xh);
  return h;
}

// The fused epilogue on the summed hops acc = D psi at the NS sites n,
// n + 1, ..., then the store (epilogue 0 none, 1 twist_inv, 2 xpay;
// CLOVER: 3 clover_inv, 4 clover_xpay).  psi0 and the clover block are
// read at those sites, as runs of NS elements; each site's arithmetic is
// the one-site code.  ROLL: the clover epilogue's two chiralities run as
// a loop, not one after the other in line (the pair kernel in halo mode:
// see the note at the top).
template <int NS, bool CLOVER, bool ROLL, typename S, typename R>
__device__ __forceinline__ void finish(cpx<R> (&acc)[NS][4][3], S* __restrict__ out,
                                       int64_t out_rs, const S* __restrict__ psi0,
                                       int64_t psi0_rs, const S* __restrict__ clov,
                                       int64_t n_sites, int64_t n, int epilogue, double tw_d,
                                       double k2_d) {
  const R tw = conv<R>(tw_d), k2 = conv<R>(k2_d);
  const R r_one = conv<R>(1.f), r_mone = conv<R>(-1.f);
  if (CLOVER) {
    // clover epilogue (tpuqcd/ops/dslash_pallas.py:461-501): per chirality,
    // the block row by row over the 6 inputs; an output row overwrites
    // only its own accumulator entry, which it alone reads
    const int64_t cl_rs = 72 * n_sites;  // re -> im plane of the clover operand
    // chirality c: spins 2c, 2c + 1 (a select on c, folded where unrolled)
    auto chirality = [&](int c) {
      const R g5 = c == 0 ? r_one : r_mone;
      cpx<R> x[NS][6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (epilogue == 3) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
            x[j][k] = c == 0 ? acc[j][k / 3][k % 3] : acc[j][2 + k / 3][k % 3];
        } else {
          const S* p0 = psi0 + ((2 * c + k / 3) * 3 + k % 3) * n_sites + n;
          R re[NS], im[NS];
          ld_run<NS>(p0, re);
          ld_run<NS>(p0 + psi0_rs, im);
#pragma unroll
          for (int j = 0; j < NS; ++j) x[j][k] = {re[j], im[j]};
        }
      }
      const S* blk = clov + (int64_t)c * 36 * n_sites + n;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        cpx<R> row[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) row[j] = {conv<R>(0.f), conv<R>(0.f)};
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const S* m = blk + (int64_t)(i * 6 + k) * n_sites;
          R mr[NS], mi[NS];
          ld_run<NS>(m, mr);
          ld_run<NS>(m + cl_rs, mi);
#pragma unroll
          for (int j = 0; j < NS; ++j) row[j] = cadd(row[j], cmul(cpx<R>{mr[j], mi[j]}, x[j][k]));
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const cpx<R> o = c == 0 ? acc[j][i / 3][i % 3] : acc[j][2 + i / 3][i % 3];
          cpx<R> r = row[j];
          if (epilogue == 4)  // (A + i tw g5) psi0 - k2 . D psi
            r = {r.re - tw * g5 * x[j][i].im - k2 * o.re, r.im + tw * g5 * x[j][i].re - k2 * o.im};
          if (c == 0)
            acc[j][i / 3][i % 3] = r;
          else
            acc[j][2 + i / 3][i % 3] = r;
        }
      }
    };
    if constexpr (ROLL) {
#pragma unroll 1
      for (int c = 0; c < 2; ++c) chirality(c);
    } else {
      chirality(0);
      chirality(1);
    }
    store_spinor<NS>(out, out_rs, n_sites, n, acc);
    return;
  }

  // fused site-term epilogue (tpuqcd/ops/dslash_pallas.py:446-460)
  const R den = r_one / (r_one + tw * tw);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const R g5 = a < 2 ? r_one : r_mone;  // gamma5 = diag(1, 1, -1, -1)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      R p0r[NS], p0i[NS];
      if (epilogue == 2) {
        const S* p0 = psi0 + (a * 3 + c) * n_sites + n;
        ld_run<NS>(p0, p0r);
        ld_run<NS>(p0 + psi0_rs, p0i);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        R rr = acc[j][a][c].re, ri = acc[j][a][c].im;
        if (epilogue == 1) {  // (1 - i tw g5) / (1 + tw^2) . D psi
          const R dr = rr, di = ri;
          rr = den * dr + (tw * den) * g5 * di;
          ri = den * di - (tw * den) * g5 * dr;
        } else if (epilogue == 2) {  // (1 + i tw g5) psi0 - k2 . D psi
          const R dr = rr, di = ri;
          rr = p0r[j] - tw * g5 * p0i[j] - k2 * dr;
          ri = p0i[j] + tw * g5 * p0r[j] - k2 * di;
        }
        acc[j][a][c] = {rr, ri};
      }
    }
  }
  store_spinor<NS>(out, out_rs, n_sites, n, acc);
}

// Threads a block of the single kernel, one or (the pair kernel) two sites
// a thread.
constexpr int SINGLE_THREADS = 128;

// The single kernel (NS = 1, a thread an output site) and the pair kernel
// (NS = 2: a thread the sites xh = 2k, 2k + 1 of one (t, z, y) row, which
// share t, z, y, the checkerboard offset o_p, the t phase and the halo
// edges, so every operand but the x legs' is a run of two elements).
template <int NS, typename S, typename R, int NROW, bool DAGGER, bool LEGS_OUT, bool CLOVER,
          bool HALO>
__global__ void __launch_bounds__(SINGLE_THREADS)
dslash_eo_kernel(const S* __restrict__ u, const S* __restrict__ psi,
                 const S* __restrict__ psi0, const S* __restrict__ clov,
                 S* __restrict__ out, int T, int Z, int Y,
                 int Xh, int p, int epilogue, double tw_d, double k2_d, int t_boundary,
                 int leg_mask, int64_t psi_rs, int64_t psi0_rs, int64_t out_rs,
                 int64_t out_ls, const S* __restrict__ f_tm, const S* __restrict__ f_tp,
                 const S* __restrict__ f_zm, const S* __restrict__ f_zp,
                 const S* __restrict__ u_tm, const S* __restrict__ u_zm, int face_spins,
                 int t_offset, int t_global) {
  using G = typename ReconOf<S>::type;
  const int64_t n_sites = (int64_t)T * Z * Y * Xh;
  const int64_t n = NS * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (n >= n_sites) return;
  const int xh = (int)(n % Xh);
  const int y = (int)((n / Xh) % Y);
  const int z = (int)((n / ((int64_t)Xh * Y)) % Z);
  const int t = (int)(n / ((int64_t)Xh * Y * Z));
  const int q = 1 - p;
  // each neighbour's index is computed where its leg reads it (hood's
  // formulas): holding all eight, as the batched kernel does, makes this
  // kernel slower
  const bool o_p = ((t + z + y + p) & 1) == 1;
  auto site = [=](int t_, int z_, int y_, int xh_) -> int64_t {
    return (((int64_t)t_ * Z + z_) * Y + y_) * Xh + xh_;
  };
  // the x legs: each site's own neighbour (one of the two legs of a pair
  // is shifted off the pair's alignment, and a run may wrap)
  int xf[NS], xb[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int x = xh + j;
    xf[j] = o_p ? x : (x + 1 == Xh ? 0 : x + 1);
    xb[j] = o_p ? (x == 0 ? Xh - 1 : x - 1) : x;
  }
  const int yf = y + 1 == Y ? 0 : y + 1, yb = y == 0 ? Y - 1 : y - 1;
  const int zf = z + 1 == Z ? 0 : z + 1, zb = z == 0 ? Z - 1 : z - 1;
  const int tf = t + 1 == T ? 0 : t + 1, tb = t == 0 ? T - 1 : t - 1;
  // the links of direction mu and parity par, one element a site
  auto links = [=](int mu, int par) -> const S* {
    return u + (int64_t)(mu * 2 + par) * link_reals(NROW) * n_sites;
  };
  auto x_sites = [=](const S* base, const int (&xs)[NS]) -> Sites<NS, S> {
    Sites<NS, S> r;
#pragma unroll
    for (int j = 0; j < NS; ++j) r.p[j] = base + site(t, z, y, xs[j]);
    return r;
  };
  // phase of a rebuilt row 2 (reconstruct-12 and -8) of a t-link at global
  // t = T-1: the forward leg's link at global t_offset + t, the backward
  // leg's one slice below
  const G one = G(1);
  const int tg = t_offset + t;
  const G ph_f = (NROW != 3 && tg == t_global - 1) ? G(t_boundary) : one;
  const G ph_b = (NROW != 3 && tg == 0) ? G(t_boundary) : one;
  // forward legs take (1 - gamma), backward legs (1 + gamma); dagger swaps
  const int sf = DAGGER ? -1 : 1;
  const int sb = -sf;
  // halo mode: the legs that step past the local t or z edge, and the
  // site's index in a t face ([Z, S]) and in a z face ([T, S])
  const bool at_tf = HALO && t == T - 1, at_tb = HALO && t == 0;
  const bool at_zf = HALO && z == Z - 1, at_zb = HALO && z == 0;
  const int64_t n_ts = (int64_t)Z * Y * Xh, n_zs = (int64_t)T * Y * Xh;
  const int64_t i_t = n % n_ts, i_z = (int64_t)t * Y * Xh + n % ((int64_t)Y * Xh);
  const bool half = face_spins == 2;
  const int64_t frs_t = (int64_t)face_spins * 3 * n_ts, frs_z = (int64_t)face_spins * 3 * n_zs;

  cpx<R> acc[NS][4][3];
#pragma unroll
  for (int j = 0; j < NS; ++j) zero(acc[j]);
  S* slot = out;

  // forward: U_mu(x)|q psi(x + mu);  backward: U_mu(x - mu)|p^dag psi(x - mu).
  // A selected leg accumulates, or (LEGS_OUT) is stored to the next slot.
#define TQ_LEG(BIT, MU, ADJ, RUN_S, PSI, PSI_RS, PSI_SS, HALF, RUN_U, UL, U_SS, SGN, PHASE)  \
  if (leg_mask & (1 << (BIT))) {                                                           \
    if (LEGS_OUT)                                                                          \
      for (int j_ = 0; j_ < NS; ++j_) zero(acc[j_]);                                       \
    leg<NS, NROW, MU, ADJ, RUN_S, RUN_U>(acc, PSI, PSI_RS, PSI_SS, HALF, UL, U_SS, PHASE, SGN); \
    if (LEGS_OUT) {                                                                        \
      store_spinor<NS>(slot, out_rs, n_sites, n, acc);                                     \
      slot += out_ls;                                                                      \
    }                                                                                      \
  }
  TQ_LEG(0, 0, false, false, x_sites(psi, xf), psi_rs, n_sites, false, true,
         run<NS>(links(0, q) + n), n_sites, sf, one)
  TQ_LEG(1, 0, true, false, x_sites(psi, xb), psi_rs, n_sites, false, false,
         x_sites(links(0, p), xb), n_sites, sb, one)
  TQ_LEG(2, 1, false, true, run<NS>(psi + site(t, z, yf, xh)), psi_rs, n_sites, false, true,
         run<NS>(links(1, q) + n), n_sites, sf, one)
  TQ_LEG(3, 1, true, true, run<NS>(psi + site(t, z, yb, xh)), psi_rs, n_sites, false, true,
         run<NS>(links(1, p) + site(t, z, yb, xh)), n_sites, sb, one)
  TQ_LEG(4, 2, false, true, run<NS>(at_zf ? f_zp + i_z : psi + site(t, zf, y, xh)),
         at_zf ? frs_z : psi_rs, at_zf ? n_zs : n_sites, at_zf && half, true,
         run<NS>(links(2, q) + n), n_sites, sf, one)
  TQ_LEG(5, 2, true, true, run<NS>(at_zb ? f_zm + i_z : psi + site(t, zb, y, xh)),
         at_zb ? frs_z : psi_rs, at_zb ? n_zs : n_sites, at_zb && half, true,
         run<NS>(at_zb ? u_zm + i_z : links(2, p) + site(t, zb, y, xh)),
         at_zb ? n_zs : n_sites, sb, one)
  TQ_LEG(6, 3, false, true, run<NS>(at_tf ? f_tp + i_t : psi + site(tf, z, y, xh)),
         at_tf ? frs_t : psi_rs, at_tf ? n_ts : n_sites, at_tf && half, true,
         run<NS>(links(3, q) + n), n_sites, sf, ph_f)
  TQ_LEG(7, 3, true, true, run<NS>(at_tb ? f_tm + i_t : psi + site(tb, z, y, xh)),
         at_tb ? frs_t : psi_rs, at_tb ? n_ts : n_sites, at_tb && half, true,
         run<NS>(at_tb ? u_tm + i_t : links(3, p) + site(tb, z, y, xh)),
         at_tb ? n_ts : n_sites, sb, ph_b)
#undef TQ_LEG
  if (LEGS_OUT) return;
  finish<NS, CLOVER, NS == 2 && HALO>(acc, out, out_rs, psi0, psi0_rs, clov, n_sites, n, epilogue,
                                       tw_d, k2_d);
}

// The batched kernel's site tile (a warp's lanes are a block's sites), its
// most column warps, and its shared link tile [8(leg), 3, 3, BATCH_SITES]
// of complex R: ops/dslash_cuda.batch_geometry mirrors these.
constexpr int BATCH_SITES = 32;
constexpr int BATCH_MAX_WARPS = 4;
template <typename R>
constexpr int batch_smem_bytes() { return 8 * 9 * BATCH_SITES * (int)sizeof(cpx<R>); }

// a leg's link in the tile, entry (i, j) of a lane at ((leg * 9 + 3 i + j) * 32 + lane):
// a warp moves 32 consecutive complex entries, without bank conflicts
template <typename R>
__device__ __forceinline__ void tile_put(cpx<R>* tile, int leg, int lane,
                                         const cpx<R> (&U)[3][3]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) tile[(leg * 9 + k) * BATCH_SITES + lane] = U[k / 3][k % 3];
}
template <typename R>
__device__ __forceinline__ void tile_get(cpx<R> (&U)[3][3], const cpx<R>* tile, int leg,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < 9; ++k) U[k / 3][k % 3] = tile[(leg * 9 + k) * BATCH_SITES + lane];
}

// N right-hand sides in one launch: phase 1 reads and rebuilds the 8
// legs' links of the block's 32 sites once, into shared memory; phase 2
// runs warp w over the columns w, w + W, ... (W = blockDim.x / 32), each
// with the same leg and epilogue code as the single kernel.  The link
// tile is the only state the columns share: the clover block is read per
// column, as is every spinor.
template <typename S, typename R, int NROW, bool DAGGER, bool CLOVER>
__global__ void __launch_bounds__(BATCH_SITES * BATCH_MAX_WARPS)
dslash_eo_batch_kernel(const S* __restrict__ u, const S* __restrict__ psi,
                       const S* __restrict__ psi0, const S* __restrict__ clov,
                       S* __restrict__ out, int T, int Z, int Y, int Xh, int p, int epilogue,
                       double tw_d, double k2_d, int t_boundary, int leg_mask, int64_t psi_rs,
                       int64_t psi0_rs, int64_t out_rs, int64_t psi_bs, int64_t psi0_bs,
                       int64_t out_bs, int n_batch, int t_block) {
  using G = typename ReconOf<S>::type;
  __shared__ cpx<R> tile[8 * 9 * BATCH_SITES];
  const int lane = threadIdx.x % BATCH_SITES, warp = threadIdx.x / BATCH_SITES;
  const int n_warps = blockDim.x / BATCH_SITES;
  const int64_t n_sites = (int64_t)T * Z * Y * Xh;
  // the block's tile: t_block consecutive blocks take the same sites of
  // t_block consecutive t-slices, so that a t-slice is read as a
  // neighbour while the L2 cache still holds it from its own tiles
  int64_t tile_id = blockIdx.x;
  if (t_block > 1) {
    const int64_t per_slice = (int64_t)Z * Y * Xh / BATCH_SITES;
    const int64_t t_in = tile_id % t_block, rest = tile_id / t_block;
    tile_id = ((rest / per_slice) * t_block + t_in) * per_slice + rest % per_slice;
  }
  const int64_t n = tile_id * BATCH_SITES + lane;
  const bool live = n < n_sites;  // the last tile may be ragged
  const Hood hd = hood(live ? n : 0, T, Z, Y, Xh, p);
  const int q = 1 - p;

  // phase 1: warp w rebuilds legs w, w + W, ... (at most 4: W >= 2),
  // coalesced over the sites; a backward leg's link sits at the neighbour,
  // the t-links carry the boundary phase on row 2 as in the single kernel.
  // Every load is unconditional (a spare leg reloads the warp's first, a
  // lane past the last site reads site 0), so the legs' loads are all in
  // flight at once; only the store is guarded.  Legs that dirs leaves out
  // are rebuilt and never read.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int leg = warp + j * n_warps;
    const int mu = (leg < 8 ? leg : warp) / 2, bwd = (leg < 8 ? leg : warp) & 1;
    const int nb = mu == 0 ? hd.nb[1] : mu == 1 ? hd.nb[3] : mu == 2 ? hd.nb[5] : hd.nb[7];
    const S* ul = u + (int64_t)(mu * 2 + (bwd ? p : q)) * link_reals(NROW) * n_sites +
                  (bwd ? nb : (live ? n : 0));
    const G phase =
        (NROW != 3 && mu == 3 && hd.t == (bwd ? 0 : T - 1)) ? G(t_boundary) : G(1);
    cpx<R> U[3][3];
    load_link<NROW>(U, ul, n_sites, phase);
    if (leg < 8) tile_put(tile, leg, lane, U);
  }
  __syncthreads();
  if (!live) return;

  // phase 2: the columns of warp w
  const int sf = DAGGER ? -1 : 1;
  const int sb = -sf;
  for (int c = warp; c < n_batch; c += n_warps) {
    const S* psi_c = psi + c * psi_bs;
    cpx<R> acc[1][4][3];
    zero(acc[0]);
#define TQ_BLEG(BIT, MU, ADJ, SGN)                                                          \
  if (leg_mask & (1 << (BIT))) {                                                           \
    cpx<R> U[3][3];                                                                        \
    tile_get(U, tile, BIT, lane);                                                          \
    hop_leg<MU, ADJ>(acc[0], psi_c + hd.nb[BIT], psi_rs, n_sites, false, U, SGN);             \
  }
    TQ_BLEG(0, 0, false, sf)
    TQ_BLEG(1, 0, true, sb)
    TQ_BLEG(2, 1, false, sf)
    TQ_BLEG(3, 1, true, sb)
    TQ_BLEG(4, 2, false, sf)
    TQ_BLEG(5, 2, true, sb)
    TQ_BLEG(6, 3, false, sf)
    TQ_BLEG(7, 3, true, sb)
#undef TQ_BLEG
    finish<1, CLOVER, false>(acc, out + c * out_bs, out_rs,
                             psi0 == nullptr ? psi0 : psi0 + c * psi0_bs, psi0_rs, clov,
                             n_sites, n, epilogue, tw_d, k2_d);
  }
}

// whether a storage type and link format have the pair kernel: bfloat16
// storage (either arithmetic) with reconstruct-12 links, the format of
// every bfloat16 operator of the port
template <typename S, int NROW>
constexpr bool has_pair() { return std::is_same<S, __nv_bfloat16>::value && NROW == 2; }

inline bool aligned4(const void* ptr) { return ((uintptr_t)ptr & 3) == 0; }

template <typename S, typename R, int NROW>
int launch(TQ_PARAMS) {
  // epilogues: 0 none, 1 twist_inv, 2 xpay, 3 clover_inv, 4 clover_xpay
  const bool clover = epilogue >= 3, reads_psi0 = epilogue == 2 || epilogue == 4;
  if (nrow != NROW || (src_parity != 0 && src_parity != 1) || epilogue < 0 || epilogue > 4 ||
      (reads_psi0 && psi0 == nullptr) || (clover && clov == nullptr) ||
      T <= 0 || Z <= 0 || Y <= 0 || Xh <= 0 || (int64_t)T * Z * Y * Xh > INT32_MAX ||
      leg_mask <= 0 || leg_mask > 255 ||
      (legs_out && epilogue != 0) || n_batch < 1 || n_batch > 65535 ||
      (n_batch > 1 && (legs_out || halo)))
    return (int)cudaErrorInvalidValue;
  // a batch takes the batched kernel with the caller's column warps (2 to
  // 4: phase 1 rebuilds at most 4 legs a warp) and t-block, and the
  // caller's count of its shared bytes must be the kernel's
  if (n_batch > 1 ? (batch_warps < 2 || batch_warps > BATCH_MAX_WARPS ||
                     batch_warps > n_batch || batch_smem != batch_smem_bytes<R>() ||
                     batch_t_block < 1 ||
                     (batch_t_block > 1 && (T % batch_t_block != 0 ||
                                            (int64_t)Z * Y * Xh % BATCH_SITES != 0)))
                  : (batch_warps != 0 || batch_smem != 0 || batch_t_block != 0))
    return (int)cudaErrorInvalidValue;
  if (halo && (legs_out || f_tm == nullptr || f_tp == nullptr || f_zm == nullptr ||
               f_zp == nullptr || u_tm == nullptr || u_zm == nullptr ||
               (face_spins != 2 && face_spins != 4) || t_offset < 0 ||
               t_offset + T > t_global))
    return (int)cudaErrorInvalidValue;
  // the pair kernel (ops/dslash_cuda.pair_sites decides): a single summed
  // launch whose every operand pair is one aligned 4-byte word: Xh even
  // (then every plane stride derived from the shape is even), each
  // pointer 4-byte aligned and each re/im stride even
  if (pair != 0 &&
      (pair != 1 || !has_pair<S, NROW>() || n_batch != 1 || legs_out || Xh % 2 != 0 ||
       !aligned4(u) || !aligned4(psi) || !aligned4(out) || psi_rs % 2 != 0 || out_rs % 2 != 0 ||
       (reads_psi0 && (!aligned4(psi0) || psi0_rs % 2 != 0)) || (clover && !aligned4(clov)) ||
       (halo && !(aligned4(f_tm) && aligned4(f_tp) && aligned4(f_zm) && aligned4(f_zp) &&
                  aligned4(u_tm) && aligned4(u_zm)))))
    return (int)cudaErrorInvalidValue;
  if (!halo) t_offset = 0, t_global = T;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int64_t n_sites = (int64_t)T * Z * Y * Xh;
  cudaStream_t s = (cudaStream_t)stream;
  const S* u_ = (const S*)u;
  const S* psi_ = (const S*)psi;
  const S* psi0_ = (const S*)psi0;
  const S* clov_ = (const S*)clov;
  S* out_ = (S*)out;
  if (n_batch > 1) {
    const unsigned blocks = (unsigned)((n_sites + BATCH_SITES - 1) / BATCH_SITES);
    const int threads = BATCH_SITES * batch_warps;
#define TQ_LAUNCH(DG, CL)                                                                    \
  dslash_eo_batch_kernel<S, R, NROW, DG, CL><<<blocks, threads, 0, s>>>(                     \
      u_, psi_, psi0_, clov_, out_, T, Z, Y, Xh, src_parity, epilogue, tw, k2, t_boundary,   \
      leg_mask, psi_rs, psi0_rs, out_rs, psi_bs, psi0_bs, out_bs, n_batch, batch_t_block)
    if (dagger) {
      if (clover) TQ_LAUNCH(true, true); else TQ_LAUNCH(true, false);
    } else {
      if (clover) TQ_LAUNCH(false, true); else TQ_LAUNCH(false, false);
    }
#undef TQ_LAUNCH
    return (int)cudaGetLastError();
  }
#define TQ_LAUNCH(NS, DG, LO, CL, HA)                                                       \
  dslash_eo_kernel<NS, S, R, NROW, DG, LO, CL, HA><<<blocks, threads, 0, s>>>(              \
      u_, psi_, psi0_, clov_, out_, T, Z, Y, Xh, src_parity, epilogue, tw, k2, t_boundary,  \
      leg_mask, psi_rs, psi0_rs, out_rs, out_ls, (const S*)f_tm, (const S*)f_tp,            \
      (const S*)f_zm, (const S*)f_zp, (const S*)u_tm, (const S*)u_zm, face_spins, t_offset, \
      t_global)
#define TQ_LAUNCH_SUM(NS, DG)                                    \
  if (halo && clover) TQ_LAUNCH(NS, DG, false, true, true);       \
  else if (halo) TQ_LAUNCH(NS, DG, false, false, true);          \
  else if (clover) TQ_LAUNCH(NS, DG, false, true, false);        \
  else TQ_LAUNCH(NS, DG, false, false, false);
  if constexpr (has_pair<S, NROW>()) {
    if (pair) {  // never legs_out (refused above)
      const int threads = SINGLE_THREADS;
      const unsigned blocks = (unsigned)((n_sites / 2 + threads - 1) / threads);
      if (dagger) { TQ_LAUNCH_SUM(2, true) } else { TQ_LAUNCH_SUM(2, false) }
      return (int)cudaGetLastError();
    }
  }
  const int threads = SINGLE_THREADS;
  const unsigned blocks = (unsigned)((n_sites + threads - 1) / threads);
  if (dagger) {
    if (legs_out) TQ_LAUNCH(1, true, true, false, false); else { TQ_LAUNCH_SUM(1, true) }
  } else {
    if (legs_out) TQ_LAUNCH(1, false, true, false, false); else { TQ_LAUNCH_SUM(1, false) }
  }
#undef TQ_LAUNCH_SUM
#undef TQ_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

#endif  // TQ_NO_KERNELS
