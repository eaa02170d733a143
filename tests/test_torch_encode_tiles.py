"""The launch plan of the VGM encode kernels (``csrc/vgm_encode.cu``), on
the CPU: the tiles cover every row once, each block's shared memory fits,
the head and tail of every staged and stored stretch come out right at
any base, and the wrappers refuse what no tile holds.  The kernel follows
the plan that :func:`encode_plan` computes and splits its stretches as
:func:`split16` does; ``tests/test_torch_cuda.py`` holds it to the plain
version on the card.  Imports only torch and numpy (and the port)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.vgm_encode import (  # noqa: E402
    MAX_THREADS, SMEM_DEFAULT, SMEM_LIMIT, buffer_floats, encode_plan,
    split16, tile_smem_bytes, vgm_encode_cuda, vgm_encode_table_cuda)

ROWS = [1, 7, 127, 128, 129, 4099, 8000, 40_000]
# (Q, Kmax): one column of one mode up to the 3,072 params the wrappers
# have always taken, odd Kmax, the main path's widths
WIDTHS = [(1, 1), (1, 3), (3, 7), (5, 10), (22, 10), (1, 10), (96, 32),
          (3, 1024), (1, 3072), (3072, 1)]


def _region(floats):
    """Floats of a stage region for ``floats`` floats: 3 of lead room,
    rounded up to 16 bytes (as ``stage_floats`` in the kernel)."""
    return -(-(floats + 3) // 4) * 4


@pytest.mark.parametrize("q,k", WIDTHS)
@pytest.mark.parametrize("n", ROWS)
def test_every_row_falls_in_exactly_one_tile(n, q, k):
    """One block per tile; tile t holds rows [t r, min((t + 1) r, n)), as
    the kernel reads its block index.  A block has whole warps, at most
    ``MAX_THREADS``, and a thread for every cell of its tile wherever a
    row has no more cells than that."""
    plan = encode_plan(n, q, k)
    r = plan.rows_per_tile
    assert r >= 1 and plan.tiles == -(-n // r) < 2 ** 31
    covered = np.zeros(n, np.int64)
    for t in range(plan.tiles):
        covered[t * r:min((t + 1) * r, n)] += 1
    assert (covered == 1).all()
    assert 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    if q <= MAX_THREADS:
        assert r * q <= plan.threads
    else:
        assert r == 1


@pytest.mark.parametrize("q,k", WIDTHS)
@pytest.mark.parametrize("n", ROWS)
def test_shared_memory_fits_a_block(n, q, k):
    plan = encode_plan(n, q, k)
    assert plan.smem_bytes == tile_smem_bytes(q, k, plan.rows_per_tile)
    assert plan.smem_bytes <= SMEM_LIMIT
    if plan.smem_attr == 0:              # the limit is not raised
        assert plan.smem_bytes <= SMEM_DEFAULT
    else:
        assert plan.smem_attr == plan.smem_bytes > SMEM_DEFAULT


@pytest.mark.parametrize("offset,n,want", [
    (0, 10, (0, 0, 2, 2)), (1, 10, (1, 3, 1, 3)), (2, 10, (2, 2, 2, 0)),
    (3, 10, (3, 1, 2, 1)), (3, 2, (3, 1, 0, 1)), (2, 1, (2, 1, 0, 0)),
    (1, 3, (1, 3, 0, 0)), (0, 0, (0, 0, 0, 0)), (5, 4, (1, 3, 0, 1))])
def test_split16_by_hand(offset, n, want):
    assert split16(offset, n) == want


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("n,q,k", [(129, 3, 7), (4099, 5, 10),
                                   (40_000, 22, 10), (8000, 1, 10),
                                   (37, 96, 32), (7, 1, 3072), (1, 1, 1)])
def test_head_and_tail_at_shifted_bases(n, q, k, shift):
    """Every tile's stretches of x and Gumbels (staged) and of slots,
    alphas and betas (stored from the output tile), with the tensors
    ``shift`` floats past a 16-byte boundary: the three parts add up, the
    16-byte body starts on a boundary in device memory and in shared
    memory (each stretch sits at its lead in its region), and every
    stretch fits its region, the table's slots the whole output tile."""
    plan = encode_plan(n, q, k)
    r = plan.rows_per_tile
    x_region, g_region = _region(r * q), _region(r * q * k)
    assert x_region + g_region == buffer_floats(r * q, k)
    for t in range(plan.tiles):
        row0, rows = t * r, min(r, n - t * r)
        cells = rows * q
        # (first float, floats, floats of its region in shared memory)
        stretches = [(row0 * q, cells, x_region),
                     (row0 * q * k, cells * k, g_region),
                     (row0 * q * (1 + k), cells * (1 + k),
                      x_region + g_region)]
        if q == 1:                       # the column entry: alpha, beta
            stretches += [(row0, cells, x_region),
                          (row0 * k, cells * k, g_region)]
        for start, length, region in stretches:
            lead, head, body, tail = split16(shift + start, length)
            assert lead == (shift + start) % 4
            assert head + 4 * body + tail == length
            assert 0 <= head <= 3 and 0 <= tail <= 3
            if body:
                assert (shift + start + head) % 4 == 0
                assert (lead + head) % 4 == 0
            assert lead + length <= region


def test_the_main_path_covers_every_sm():
    """At the main path's shapes, the column entry at 8,000 and 40,000
    rows and the table at 22 and 5 columns, every one of the card's 132
    SMs gets at least two tiles, and 8 blocks fit on an SM at once."""
    for n, q in ((8000, 1), (40_000, 1), (40_000, 22), (40_000, 5),
                 (8000, 5)):
        plan = encode_plan(n, q, 10)
        assert plan.tiles >= 2 * 132
        assert 8 * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("q,k", [(1, 12_000), (4, 3000), (24, 500)])
def test_wrappers_raise_past_the_limit(q, k):
    with pytest.raises(ValueError, match="shared memory"):
        encode_plan(8, q, k)
    with pytest.raises(ValueError, match="shared memory"):
        vgm_encode_table_cuda(torch.zeros(8, q), torch.zeros(q, k),
                              torch.ones(q, k), torch.zeros(q, k),
                              torch.zeros(8, q * k))
    if q == 1:
        with pytest.raises(ValueError, match="shared memory"):
            vgm_encode_cuda(torch.zeros(8), torch.zeros(k), torch.ones(k),
                            torch.zeros(k), torch.zeros(8, k))


@pytest.mark.parametrize("q,k", [(96, 32), (1, 3072), (3072, 1)])
def test_wrappers_take_the_old_limit(q, k):
    """Q * Kmax = 3,072 plans, and the wrapper goes on to its device check
    (these tensors are on the CPU)."""
    encode_plan(40_000, q, k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        vgm_encode_table_cuda(torch.zeros(8, q), torch.zeros(q, k),
                              torch.ones(q, k), torch.zeros(q, k),
                              torch.zeros(8, q * k))
