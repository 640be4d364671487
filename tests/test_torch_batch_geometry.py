"""The batched Dslash kernel's launch geometry (ops/dslash_cuda.
batch_geometry), which the CUDA launch takes as it is: for N = 1 to 64 and
65535 right-hand sides, every storage and arithmetic type and every link
format, the column warps, threads, shared bytes and the columns each warp
takes; and the order in which blocks take the site tiles, t-slices in
blocks where a slice streams more than the L2 keeps.  The tile holds the
rebuilt 3x3 links, so the link format enters the order only.  Plain
arithmetic, no card and no tpuqcd needed."""
import pytest
import torch

from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.ops.dslash_cuda import (BATCH_MAX_WARPS, BATCH_SITES, BATCH_T_BLOCK,
                                          L2_BYTES, LINK_ROWS, batch_geometry)

#: storage dtype, compute, bytes of the arithmetic type the tile holds
TYPES = [(torch.float32, "f32", 4), (torch.bfloat16, "f32", 4), (torch.float64, "f32", 8),
         (torch.bfloat16, "bf16", 2)]
WIDTHS = list(range(2, 65)) + [65535]
#: static shared memory a block may hold without cudaFuncSetAttribute
STATIC_SMEM_MAX = 48 * 1024
LAT = Lattice((32, 32, 32, 64))


@pytest.mark.parametrize("link_reals", sorted(LINK_ROWS.values()))
@pytest.mark.parametrize("dtype,compute,arith", TYPES, ids=["f32", "bf16", "f64", "bf16c"])
def test_batch_geometry_fits_the_card_and_covers_every_column(dtype, compute, arith, link_reals):
    assert batch_geometry(1, LAT, dtype, link_reals, compute) is None     # a single launch
    item = torch.empty((), dtype=dtype).element_size()
    for n in WIDTHS:
        g = batch_geometry(n, LAT, dtype, link_reals, compute)
        assert 2 <= g.warps <= min(n, BATCH_MAX_WARPS)      # the kernel refuses 1
        assert g.threads == BATCH_SITES * g.warps <= 1024
        # static shared memory: no cudaFuncSetAttribute needed
        assert g.shared_bytes == 8 * 18 * BATCH_SITES * arith <= STATIC_SMEM_MAX
        taken = sorted(c for w in range(g.warps) for c in g.columns(w, n))
        assert taken == list(range(n))
        # the fewest steps, and no warp idle for a whole step
        steps = max(len(g.columns(w, n)) for w in range(g.warps))
        assert steps == -(-n // min(n, BATCH_MAX_WARPS))
        assert min(len(g.columns(w, n)) for w in range(g.warps)) >= steps - 1
        # t-blocks where a t-slice streams more than a quarter of the L2
        streamed = 32 * 32 * 16 * (72 * n + 8 * link_reals) * item
        assert g.t_block == (BATCH_T_BLOCK if streamed > L2_BYTES / 4 else 1)


@pytest.mark.parametrize("dims,n,t_block", [((32, 32, 32, 64), 11, BATCH_T_BLOCK),
                                            ((32, 32, 32, 64), 2, BATCH_T_BLOCK),
                                            ((32, 32, 32, 48), 2000, BATCH_T_BLOCK),
                                            ((8, 8, 8, 16), 2000, BATCH_T_BLOCK),
                                            ((8, 8, 8, 16), 11, 1),     # a slice in the L2
                                            ((4, 4, 4, 12), 2000, 1),   # T not a multiple of 8
                                            ((4, 2, 2, 8), 2000, 1)])   # a slice of 8 sites
def test_blocks_take_every_site_tile_once(dims, n, t_block):
    lat = Lattice(dims)
    g = batch_geometry(n, lat, torch.float32, 12)
    assert g.t_block == t_block
    T, Z, S = lat.site_shape
    n_tiles = -(-lat.half_volume // BATCH_SITES)
    order = [g.tile(b, Z * S // BATCH_SITES) for b in range(n_tiles)]
    assert sorted(order) == list(range(n_tiles))
    if t_block > 1:
        # consecutive blocks: the same sites of consecutive t-slices
        per_slice = Z * S // BATCH_SITES
        assert order[:t_block] == [t * per_slice for t in range(t_block)]


def test_batch_geometry_of_the_widths_the_paths_launch():
    f32 = dict(lat=LAT, dtype=torch.float32, link_reals=12)
    assert batch_geometry(4, **f32).warps == 4                 # cell 4i: a column a warp
    g11, g5 = batch_geometry(11, **f32), batch_geometry(5, **f32)
    assert (g11.warps, g11.threads) == (4, 128)                # cell 4h: 3, 3, 3, 2 columns
    assert [len(g5.columns(w, 5)) for w in range(g5.warps)] == [2, 2, 1]   # not 2, 1, 1, 1
    assert batch_geometry(2, LAT, torch.float64, 18).shared_bytes == 36864
    # the lockstep MG smoother (bf16, 4 columns) streams 12.6 MB a t-slice:
    # site order; its fine operator (f32) 25.2 MB: t-blocks
    assert batch_geometry(4, LAT, torch.bfloat16, 12).t_block == 1
    assert batch_geometry(4, **f32).t_block == BATCH_T_BLOCK
    for n in (0, 65536):
        with pytest.raises(ValueError, match="1 to 65535"):
            batch_geometry(n, **f32)
