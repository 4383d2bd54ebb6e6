"""The CPU model of the Hopper core (``csrc/hcore.cuh``), of the pass
kernel's tile schedule (``csrc/fourstep.cu``), of the row kernels
(``csrc/c2c.cu``, the R2C kernel of ``csrc/real.cu``, the C2R kernel of
``csrc/c2r.cu``), of the reuse loops (``csrc/multiple.cu``) and of the
fused convolutions (``csrc/conv.cu``): ``models/hcore.py``.

What a CPU can check of the nine kernels on that core: the stage ladder
and its index maps give numpy's DFT at every size the kernels
instantiate, the Bluestein order of H and its two shortcuts (the first
stage's zero half, the last stage's lower half) change nothing, the row
kernels' layouts (revblock staging in and out, the R2C pair split and
its stores) give numpy's fft / rfft and store each bin once, the C2R
kernel's loads and merge in the registers (from device memory, or from
the revblock staging) give ``ops.real``'s plain version and the JAX
package's fused C2R, forming each point once, the reuse
loops' hand-offs (natural in the registers, revblock through the
staging) and the real round trip's in-place split and merge give
``ops.multiple``'s plain versions, the convolutions' products in the
registers and in place give ``ops.convolve``'s plain versions, every
shared-memory access needs the fewest wavefronts a warp can (2 for
8-byte elements, 4 for 16-byte ones; the shared core of ``stockham.cuh``
is counted the same way), the paddings are bijections, and the
persistent grid covers every tile once. Tolerance: 1e-9 * M against
complex128 numpy (the model runs in float64); against the JAX package,
whose kernels run in float32, 2 tol(n) L with tol(n) = 5e-7 n^0.75 8 (as
``tests/test_torch_real.py``).
"""

import numpy as np
import pytest
import torch

from smfft_tpu_torch import bluestein as TB
from smfft_tpu_torch.models import hcore as H
from smfft_tpu_torch.ops import c2c as OC
from smfft_tpu_torch.ops import convolve as CV
from smfft_tpu_torch.ops import multiple as MU
from smfft_tpu_torch.ops import real as R

BLUESTEIN_M = [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384]
PASS_R = [16, 32, 64, 128, 256, 512, 1024, 2048]


def rand_c(rng, *shape):
    return rng.random(shape) - 0.5 + 1j * (rng.random(shape) - 0.5)


@pytest.mark.parametrize("kernel,m", [("bluestein", m) for m in BLUESTEIN_M]
                         + [("pass", r) for r in PASS_R])
@pytest.mark.parametrize("inverse", [False, True])
def test_ladder_gives_the_dft(rng, m, kernel, inverse):
    tpf = (m // H.points_per_thread(m) if kernel == "bluestein"
           else H.pass_geometry(m, False)["TPF"])
    x = rand_c(rng, 3, m)
    want = np.fft.ifft(x) * m if inverse else np.fft.fft(x)
    assert np.abs(H.core(x, tpf, inverse) - want).max() < 1e-9 * m
    assert np.prod(H.radices(m)) == m


@pytest.mark.parametrize("m", BLUESTEIN_M)
def test_zero_half_and_lower_half_change_nothing(rng, m):
    tpf = m // H.points_per_thread(m)
    x = rand_c(rng, 2, m)
    x[:, m // 2:] = 0
    full = H.core(x, tpf)
    np.testing.assert_allclose(H.core(x, tpf, zero_half=True), full,
                               atol=1e-9 * m)
    low = H.core(x, tpf, True, lower_half=True)
    np.testing.assert_allclose(low[:, :m // 2],
                               H.core(x, tpf, True)[:, :m // 2],
                               atol=1e-9 * m)
    assert not low[:, m // 2:].any()


@pytest.mark.parametrize("n", [3, 17, 100, 129, 1000, 1536, 4097, 8191])
@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_in_register_order(rng, n, inverse):
    """H multiplied in the registers where the forward core leaves the
    spectrum (natural order) gives the DFT; H in any other order does
    not."""
    m = TB._conv_length(2 * n - 1)
    x = rand_c(rng, 2, n)
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    got = H.bluestein(x, n, m, inverse)
    assert np.abs(got - want).max() < 1e-9 * m
    if n >= 100:
        j = np.arange(n)
        w = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
        b = np.zeros(m, complex)
        b[:n] = np.conj(w)
        b[m - n + 1:] = np.conj(w[1:][::-1])
        h = np.fft.fft(b) / m
        wrong = H.bluestein(x, n, m, False, h_order=h[::-1].copy())
        assert np.abs(wrong - np.fft.fft(x)).max() > 1e-3


@pytest.mark.parametrize("m", BLUESTEIN_M)
@pytest.mark.parametrize("elem", [8, 16])
def test_bluestein_banks(m, elem):
    """Every stage access and twiddle read of a Bluestein block at the
    minimum wavefronts: 2 for complex64 storage, 4 for complex128."""
    waves = [w for _, w in H.bluestein_patterns(m, elem)]
    assert waves and max(waves) <= elem // 4


@pytest.mark.parametrize("r", PASS_R)
@pytest.mark.parametrize("exact", [False, True])
def test_pass_banks(r, exact):
    """The pass kernel's tile copies (column and row maps), every stage
    from the staged tile, the row-out staging and the twiddle reads at the
    minimum wavefronts."""
    g = H.pass_geometry(r, exact)
    waves = [w for _, w in H.pass_patterns(r, exact)]
    assert max(waves) <= g["elem"] // 4


def test_old_core_first_stage_store_counts_16_wavefronts():
    """stockham.cuh's first_stage stores buf[i * 8 + r]: lanes 64 bytes
    apart, 16 wavefronts for an 8-byte store where 2 would do."""
    assert H.wavefronts([(i * 8 + 0) * 8 for i in range(32)], 8) == 16
    assert H.wavefronts([i * 8 for i in range(32)], 8) == 2


@pytest.mark.parametrize("m", BLUESTEIN_M)
def test_padding_is_a_bijection(m):
    pos = H.pad16(np.arange(m))
    assert len(np.unique(pos)) == m and pos.max() < H.slot_elems(m)


@pytest.mark.parametrize("r", PASS_R)
@pytest.mark.parametrize("exact", [False, True])
def test_pass_tile_layout(r, exact):
    """Slots of a tile are disjoint and fit the shared memory; the lanes
    map onto (transform, thread) one to one; a column tile's row is at
    least 128 contiguous bytes, 64 at R = 1024 / 2048 (where two tiles of
    128 do not fit)."""
    g = H.pass_geometry(r, exact)
    pad = H.pad16 if g["pad"] else (lambda i: i)
    f, j = np.meshgrid(np.arange(g["T"]), np.arange(r), indexing="ij")
    pos = f * g["LD"] + pad(j)
    assert len(np.unique(pos)) == g["T"] * r
    assert pos.max() < g["T"] * g["LD"]
    assert g["NB"] * g["T"] * g["LD"] * g["elem"] <= 140 * 1024
    lanes = {H.pass_lane(tid, g) for tid in range(g["threads"])}
    assert lanes == {(a, b) for a in range(g["T"]) for b in range(g["TPF"])}
    assert g["T"] * g["elem"] >= (64 if r >= 1024 else 128)


@pytest.mark.parametrize("total,t,per_sm", [
    (128, 16, 1),      # fewer tiles than SMs (2^15 points, radix 256)
    (3 * 64, 128, 2),  # a ragged last tile (2048 points, radix 32, b = 3)
    (8192, 16, 1),     # many tiles a block
    (1, 16, 2),        # one transform
    (2 ** 21, 16, 2),  # 2^28 points, radix 128
])
def test_tile_schedule_covers_every_transform_once(total, t, per_sm):
    n_tiles = -(-total // t)
    grid = H.grid_size(n_tiles, 132, per_sm)
    tiles = H.tile_schedule(n_tiles, grid)
    assert len(tiles) == grid <= n_tiles
    flat = sorted(x for b in tiles for x in b)
    assert flat == list(range(n_tiles))
    covered = [g for tile in flat for g in range(tile * t, tile * t + t)
               if g < total]
    assert covered == list(range(total))


# the pair split in the last pass: (N, the last radix of its plan, Z rows,
# spectrum rows).  2^11 / 2^12 / 2^13 at 256: tiles span rows (S/2 < T/2),
# the last one ragged at 3 rows; 2^15: rowfour's 256 x 128 (a tile within
# a row); an odd batch leaves its last q row out.
SPLIT_CASES = [(1 << 11, 32, 3, 5), (1 << 12, 64, 1, 2),
               (1 << 15, 128, 2, 4), (1 << 15, 128, 2, 3),
               (1 << 16, 256, 2, 4), (1 << 13, 256, 3, 6), (256, 16, 4, 8)]
SPLIT_R = [16, 32, 64, 128, 256]


@pytest.mark.parametrize("n,r,b,rows", SPLIT_CASES)
@pytest.mark.parametrize("exact", [False, True])
def test_pass_split_is_the_pair_split_storing_each_bin_once(rng, n, r, b,
                                                           rows, exact):
    """The split epilogue's slots, mirror reads and stores give
    ``real_fused.pair_split_plain`` of the pass's output, every bin of
    every spectrum row stored once, transforms 0 and S/2 paired with
    themselves."""
    from smfft_tpu_torch.ops import real_fused as RF
    z = rand_c(rng, b, n)
    got, stores = H.pass_split(z, r, exact, rows)
    xr, xi = RF.pair_split_plain(torch.from_numpy(z), rows)
    assert np.array_equal(got, (xr + 1j * xi).numpy())
    assert (stores == 1).all()


@pytest.mark.parametrize("n,r", [(1 << 11, 32), (1 << 15, 128),
                                 (1 << 23, 128), (1 << 24, 256)])
def test_pass_split_slots_hold_every_transform_once(n, r):
    """A split pass's tiles hold each transform of each row once, slot f
    and f + T/2 a pair (c, S - c), transforms 0 and S/2 in one pair's
    slots."""
    g = H.split_geometry(r, False)
    s, b = n // r, 3
    total = b * s
    h = g["T"] // 2
    held = []
    for tile in range(-(-total // g["T"])):
        for f in range(h):
            lo = H.pass_split_slot(g, tile, f, s, total)
            hi = H.pass_split_slot(g, tile, f + h, s, total)
            assert (lo < 0) == (hi < 0)
            if lo >= 0:
                assert lo // s == hi // s
                c, m = lo % s, hi % s
                assert (c, m) == (0, s // 2) or c + m == s
                held += [lo, hi]
    assert sorted(held) == list(range(total))


@pytest.mark.parametrize("r", SPLIT_R)
@pytest.mark.parametrize("exact", [False, True])
def test_pass_split_banks(r, exact):
    """The split tile's row copy and core stages under its lanes, its
    writes of the upper outputs and its mirror reads at the minimum
    wavefronts."""
    g = H.split_geometry(r, exact)
    assert max(w for _, w in H.pass_split_patterns(r, exact)) \
        <= g["elem"] // 4


@pytest.mark.parametrize("r", SPLIT_R)
@pytest.mark.parametrize("exact", [False, True])
def test_split_tile_layout(r, exact):
    """The split tile's two buffers of twice the plain pass's transforms
    fit its 140 KB and a block's 1024 threads, unpadded, and its lanes map
    onto (slot, thread) one to one; a side's run of adjacent bins is 256
    bytes of complex64 or more to R = 128 (the plain tile's half gave 128
    there), 128 at R = 256."""
    g = H.split_geometry(r, exact)
    assert g["NB"] * g["T"] * g["LD"] * g["elem"] <= 140 * 1024
    assert not g["pad"] and g["threads"] <= 1024 and g["E"] * g["TPF"] == r
    lanes = {H.pass_lane(tid, g) for tid in range(g["threads"])}
    assert lanes == {(a, b) for a in range(g["T"]) for b in range(g["TPF"])}
    if not exact:
        assert g["T"] // 2 * 8 >= (256 if r <= 128 else 128)


# the fused tail's plans: N and its radices (R1, R2, R3); rows of Z
TAIL_PLANS = [(1 << 21, (128, 128, 128)), (1 << 22, (256, 128, 128)),
              (1 << 23, (512, 128, 128)), (1 << 24, (1024, 128, 128))]


def _slot_blocks(tile, rs, rows):
    """The blocks (row * R1 + d1) of the transforms a split tile's slots
    hold (:func:`pass_split_slot`)."""
    r1, r2, r3 = rs
    g, s = H.split_geometry(r3, False), r1 * r2
    slots = (H.pass_split_slot(g, tile, f, s, rows * s)
             for f in range(g["T"]))
    return {c // s * r1 + c % s % r1 for c in slots}


@pytest.mark.parametrize("n,rs", TAIL_PLANS)
def test_tail_items_share_threads_and_a_buffer(n, rs):
    """The fused plan at N is (N / 2^14, 128, 128); its pass-2 item and
    split item run on the same 512 threads with E = 16 points each; a
    block's transforms are whole pass-2 items; a split item is the split
    pass's tile (runs of 256 bytes of bins); two tile buffers, each holding
    either item unpadded, and two twiddle tables fit an SM."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    r1, r2, r3 = rs
    fused = FF.tail_plan(n, FF.pair_split_plan(n))
    assert [p.radix for p in fused] == [r1, r2] and fused[1].then.radix == r3
    g, s = H.tail_geometry(r2, r3), H.split_geometry(r3, False)
    assert g["threads"] == s["threads"] == g["T2"] * g["TPF2"] == 512
    assert g["E"] == s["E"] == 16 and g["T2"] % 32 == 0
    assert g["T2"] * g["per_block"] == r3 and r1 % (2 * g["H"]) == 0
    assert g["H"] * 8 == 256 and g["NP"] == g["NC"]
    slots = max(g["T2"] * (r2 + 1), s["T"] * s["LD"])
    assert (2 * slots + 2 * g["T2"] * g["E"] + 32) * 8 + 1024 <= 227 * 1024


@pytest.mark.parametrize("n,rs", TAIL_PLANS)
@pytest.mark.parametrize("rows", [1, 3])
def test_tail_items_hold_every_pass_tile_and_split_pair_once(n, rs, rows):
    """The tickets of a tail launch hand out every pass-2 item of every
    block once and every split tile once, and those tiles' slots hold
    every transform of the split pass once: every pair once."""
    r1, r2, r3 = rs
    g = H.tail_geometry(r2, r3)
    items = H.tail_items(rows, rs)
    assert sorted(it[1:] for it in items if it[0] == "pass") == [
        (b, sub) for b in range(rows * r1) for sub in range(g["per_block"])]
    tiles = sorted(it[1] for it in items if it[0] == "split")
    assert tiles == list(range(rows * r1 * r2 // (2 * g["H"])))
    sg, s = H.split_geometry(r3, False), r1 * r2
    held = sorted(H.pass_split_slot(sg, t, f, s, rows * s)
                  for t in tiles for f in range(sg["T"]))
    assert held == list(range(rows * s))


@pytest.mark.parametrize("n,rs", TAIL_PLANS)
@pytest.mark.parametrize("rows", [1, 3])
def test_tail_split_items_wait_only_on_earlier_pass_items(n, rs, rows):
    """Each split item waits for the blocks its slots read, and every
    pass-2 item of those blocks has a lower ticket (so a waiting item
    waits only on items that running blocks hold: no deadlock), handed out
    at least half a group pair's pass-2 items before it (so it rarely
    waits)."""
    r1, r2, r3 = rs
    g = H.tail_geometry(r2, r3)
    last = {}
    for i, it in enumerate(H.tail_items(rows, rs)):
        if it[0] == "pass":
            last[it[1]] = i
            continue
        reads = H.tail_reads(it[1], rs)
        assert set(reads) == _slot_blocks(it[1], rs, rows)
        assert all(b in last for b in reads)
        assert i - max(last[b] for b in reads) > g["NP"] // 2


@pytest.mark.parametrize("n,rs", TAIL_PLANS)
def test_tail_slot_rows_are_the_row_maps_of_the_split_slots(n, rs):
    """The rows a split item loads and discards, from its digits, are the
    digit-reversed rows (R1, R2) of the transforms ``pass_split_slot``
    puts in its slots, over every tile of three Z rows."""
    r1, r2, r3 = rs
    sg, s, rows = H.split_geometry(r3, False), r1 * r2, 3
    for tile in range(rows * s // sg["T"]):
        for f in range(sg["T"]):
            g = H.pass_split_slot(sg, tile, f, s, rows * s)
            d1, d2 = g % s % r1, g % s // r1
            assert H.tail_slot_row(tile, f, rs) == (
                g // s * n + (d1 * r2 + d2) * r3)


@pytest.mark.parametrize("k", range(21, 27))
def test_tail_engages_at_2e21_to_2e24_with_8_mib_group_pairs(k):
    """The fused tail engages at 2^21 .. 2^24, whose plan (N / 2^14, 128,
    128) has a group pair of 8 MiB (the model's count of its pass-2 items'
    blocks) at every N.  2^25 (pass 1 of radix 2048) and 2^26 keep the
    three launches, and so do "exact" and plans without the split."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    n = 1 << k
    plan = FF.pair_split_plan(n)
    fused = FF.tail_plan(n, plan)
    assert (len(fused) == 2) == (k <= 24)
    if k <= 24:
        rs = (fused[0].radix, fused[1].radix, fused[1].then.radix)
        assert rs == (n >> 14, 128, 128)
        assert H.tail_group_bytes(rs) == 8 << 20
        assert fused[1].then.split == "pair"
    assert FF.tail_plan(n, plan, exact=True) == plan
    assert FF.tail_plan(n, FF.default_passes(n)) == FF.default_passes(n)


# the fused column launch: (rows, M, K) of the grids it runs on, stride K at
# one slab a row, a few, and many
COLUMN_GRIDS = [(1, 4096, 64), (2, 4096, 256), (1, 8192, 64),
                (3, 8192, 128), (1, 16384, 32), (2, 16384, 128),
                (1, 16384, 1024)]


def _column_radices(m):
    """The radices of the column plan's two passes at M."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    return FF.radices(m, 2)


@pytest.mark.parametrize("m", [4096, 8192, 16384])
def test_column_items_share_threads_and_fit_two_blocks_an_sm(m):
    """The fused column launch's two sides at the column plan's radices:
    256 threads, E = 16 points a thread, the lanes of a warp across 32
    transforms (256-byte runs), an item of 32 KiB; a slab is the wider
    item's columns and holds as many items of each side; LAG + 1 slabs
    fit the L2 budget; two blocks of two item buffers and the tables fit
    an SM; the plan's slab is the model's."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    rs = FF.radices(m, 2)
    assert rs in FF.COLUMN_PAIRS
    g = H.column_geometry(*rs)
    for side in (g["A"], g["B"]):
        assert side["T"] * side["TPF"] == g["threads"] == 256
        assert side["E"] == 16 and side["FW"] == 32
        assert side["T"] * side["R"] * 8 == 32 << 10
    assert g["W"] % g["A"]["T"] == g["W"] % g["B"]["T"] == 0
    assert g["NI"] == g["W"] // g["B"]["T"] * rs[0]
    assert (g["LAG"] + 1) * g["slab_bytes"] <= H.COLUMN_L2_BYTES
    assert g["LAG"] >= 4
    assert FF.column_slab(*rs) == g["W"]
    smem = (2 * 4096 + 16 + 16 + rs[0]) * 8
    assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("rows,m,k", COLUMN_GRIDS)
def test_column_items_write_every_point_once_a_pass(rows, m, k):
    """The tickets hand out every transform of pass A and of pass B once;
    pass A writes every point of the grid once, in place, and pass B reads
    every point once and writes every point once."""
    rs = _column_radices(m)
    items = H.column_items(rows, k, rs)
    n = rows * m * k
    for side, r in (("A", rs[0]), ("B", rs[1])):
        firsts = sorted(it[2] for it in items if it[0] == side)
        t = 4096 // r
        assert firsts == list(range(0, n // r, t))
        pts = [H.column_points(it, k, rs) for it in items if it[0] == side]
        for which in (0, 1):
            got = np.sort(np.concatenate([p[which].ravel() for p in pts]))
            assert np.array_equal(got, np.arange(n))


@pytest.mark.parametrize("rows,m,k", COLUMN_GRIDS)
def test_column_pass_b_items_wait_only_on_lower_tickets(rows, m, k):
    """Each pass-B item reads only points that pass-A items of its own slab
    wrote, every one of them at a lower ticket (a waiting item waits only
    on items that running blocks hold: no deadlock), the slab's last over
    LAG - 1 slabs' pass-A items before it where the grid has more than LAG
    slabs."""
    rs = _column_radices(m)
    g = H.column_geometry(*rs)
    items = H.column_items(rows, k, rs)
    owner = np.full(rows * m * k, -1)
    slab_of = np.full(rows * m * k, -1)
    for i, it in enumerate(items):
        if it[0] == "A":
            owner[H.column_points(it, k, rs)[1].ravel()] = i
            slab_of[H.column_points(it, k, rs)[1].ravel()] = it[1]
    slabs = rows * (k // g["W"])
    for i, it in enumerate(items):
        if it[0] != "B":
            continue
        read = H.column_points(it, k, rs)[0].ravel()
        assert (slab_of[read] == it[1]).all()
        assert owner[read].max() < i
        if slabs > g["LAG"]:
            assert i - owner[read].max() > (g["LAG"] - 1) * g["NI"]


@pytest.mark.parametrize("rows,m,k", COLUMN_GRIDS)
def test_column_slabs_in_l2_stay_within_the_budget(rows, m, k):
    """In ticket order at most LAG + 1 slabs are open at once (a slab from
    its first pass-A ticket to its last pass-B ticket): the intermediate
    in flight stays inside the L2 budget."""
    rs = _column_radices(m)
    g = H.column_geometry(*rs)
    most = H.column_in_flight(rows, k, rs)
    slabs = rows * (k // g["W"])
    assert most == min(slabs, g["LAG"] + 1)
    assert most * g["slab_bytes"] <= H.COLUMN_L2_BYTES


# ---------------------------------------------------------------------------
# The row kernels on the core: c2c_kernel and the R2C kernel.
# ---------------------------------------------------------------------------

ROW_M = [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384]
REAL_N = [64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384]


def to_rev(x):
    """Natural rows -> revblock rows (position k2*128 + k1 holds k1*c + k2)."""
    c = max(1, x.shape[1] // 128)
    return x[:, H.revblock_index(np.arange(x.shape[1]), c)]


@pytest.mark.parametrize("m", ROW_M)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["ordered", "rev_out", "rev_in", "rev_both"])
def test_c2c_model_gives_the_dft(rng, m, inverse, mode):
    """c2c_kernel's index maps (staging, core, scale) give numpy's DFT
    in every layout."""
    rev_in, rev_out = mode in ("rev_in", "rev_both"), mode in ("rev_out",
                                                                 "rev_both")
    x = rand_c(rng, 2, m)
    want = (np.fft.ifft(x) * m if inverse else np.fft.fft(x)) * 0.5
    got = H.c2c_rows(to_rev(x) if rev_in else x, inverse, rev_in, rev_out,
                     0.5)
    assert np.abs(got - (to_rev(want) if rev_out else want)).max() \
        < 1e-9 * m


def packed_rfft(x, layout):
    """numpy's rfft of x in one of the R2C kernel's four layouts."""
    want = np.fft.rfft(x)
    L = x.shape[1] // 2
    if layout == "numpy":
        return want
    out = want[:, :L].copy()
    out[:, 0] = want[:, 0].real + 1j * want[:, L].real
    return to_rev(out) if layout == "planar_rev" else out


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("layout", H.REAL_LAYOUTS)
def test_r2c_model_gives_rfft(rng, n, layout):
    """The R2C kernel's index maps (the core at L, the pair split, the
    layout's stores) give numpy's rfft in every layout."""
    x = rng.random((2, n)) - 0.5
    got, _ = H.r2c_rows(x, layout)
    assert np.abs(got - packed_rfft(x, layout)).max() < 1e-9 * n


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("layout", H.REAL_LAYOUTS)
def test_r2c_stores_every_bin_once(rng, n, layout):
    """The split's stores to device memory (the natural layouts straight
    from the pair threads, planar_rev by position) cover each bin once."""
    _, hits = H.r2c_rows(rng.random((1, n)) - 0.5, layout)
    assert hits.shape == (n // 2 + (layout == "numpy"),)
    assert (hits == 1).all()


@pytest.mark.parametrize("kernel,m", [("c2c", m) for m in ROW_M]
                         + [("r2c", n // 2) for n in REAL_N]
                         + [("c2r", n // 2) for n in REAL_N])
@pytest.mark.parametrize("exact", [False, True])
def test_row_kernel_banks(m, exact, kernel):
    """Every shared-memory access of a block at the minimum wavefronts (2
    for 8-byte elements, 4 for 16-byte): the core's stages under F rows a
    block, the revblock staging by position and by logical point, the
    last stage's Z, the split's pair reads (k ascending, L-k descending),
    the C2R kernel's reads of X[p] from its revblock staging, and the
    stage twiddle table (W^k and the anchors W^(4k)).  One access is a
    wavefront over: the C2R kernel's reads of the mirror bins X[L-p] from
    the staging.  A warp's bins p are an aligned run of 32, its bins L-p a
    run one off (L - p for p = t0..t0+31), and no layout of the staging
    serves both runs and the writes by position at the minimum (the two
    runs differ by one bin, so its two positions would have to share their
    banks, and then the writes of consecutive positions would not); the
    kernel pays that wavefront rather than a second pass through shared
    memory."""
    g = (H.c2r_geometry(m, exact) if kernel == "c2r"
         else H.row_geometry(m, exact, H.ROW_WARPS[kernel]))
    pats = H.row_patterns(m, exact, kernel)
    kinds = {what for what, _ in pats}
    if g["CB"] > 1:
        assert ({"rev in: by position", "rev in: X[p]", "rev in: X[L-p]"}
                if kernel == "c2r" else {"revblock by position"}) <= kinds
    if kernel == "r2c":
        assert {"pair read k", "pair read L-k", "Z out: last stage"} <= kinds
    for what, w in pats:
        lim = (16 if exact else 8) // 4 if what.startswith("tw") \
            else g["elem"] // 4
        assert w <= lim + (what == "rev in: X[L-p]"), (what, w)


@pytest.mark.parametrize("kernel,m", [("c2c", m) for m in ROW_M]
                         + [("r2c", n // 2) for n in REAL_N]
                         + [("c2r", n // 2) for n in REAL_N])
@pytest.mark.parametrize("exact", [False, True])
def test_row_geometry(kernel, m, exact):
    """A block's rows are disjoint and fit the shared memory with the
    table; the staging is a bijection inside a slot; 256 threads up to
    M = 4096 (N = 32 / 64 pack 128 / 64 rows), one row of 512 above; two
    buffers a row only where the blocks an SM (16, 24 or 32 warps for
    fp32, 16 for "exact") fit with them; the C2R kernel's revblock staging
    in the second buffer where there are two."""
    g = H.row_geometry(m, exact, H.ROW_WARPS[kernel])
    assert g["threads"] == g["F"] * g["TPF"] <= 1024
    assert g["threads"] == (256 if m <= 4096 else 512)
    assert g["F"] == {32: 128, 64: 64}.get(m, max(1, 4096 // m))
    assert g["BUF"] >= (2 if g["PP"] else 1) * g["SLOT"]
    assert g["smem"] <= 232448
    assert g["MINB"] * (g["smem"] + 1024) <= 233472
    if g["PP"]:  # the second buffer costs no block an SM
        assert g["MINB"] == max(1, (16 if exact else H.ROW_WARPS[kernel])
                                * 32 // g["threads"])
    stage = H.stage_pos(np.arange(m), g)
    assert len(np.unique(stage)) == m and stage.max() < g["SLOT"]
    assert len(np.unique(H.pad16(np.arange(m)))) == m
    if kernel == "c2r":  # the staging: the second buffer, or the only one
        off = H.c2r_geometry(m, exact)["OFF"]
        assert off == (g["SLOT"] if g["PP"] else 0)
        assert off + stage.max() < g["BUF"]


def spectrum_in(rng, n, layout, rows=2):
    """Seeded real rows x (rows, n) and numpy's rfft of them in one of
    the C2R kernel's layouts, as a complex array (a planar pair joined)."""
    x = rng.random((rows, n)) - 0.5
    full = np.fft.rfft(x)
    if layout == "numpy":
        full[:, [0, -1]] += 0.25j  # the kernel ignores these
    return x, full if layout == "numpy" else packed_rfft(x, layout)


@pytest.mark.parametrize("n", REAL_N[:-1])
@pytest.mark.parametrize("layout", H.REAL_LAYOUTS)
def test_c2r_model_matches_plain(rng, n, layout):
    """The C2R kernel's index maps (each thread's points p = t + s*TPF and
    their mirrors L-p read from device memory or from the revblock
    staging, merged with W_n^p and the scale in the registers, the
    inverse core from them) give ``c2r_plain`` in float64, and at numpy's
    scale 1/L the rows x themselves."""
    L = n // 2
    x, spec = spectrum_in(rng, n, layout)
    got, _, _ = H.c2r_rows(spec, layout, 1.0 / L)
    planes = ((torch.from_numpy(spec.real.copy()),
               torch.from_numpy(spec.imag.copy()))
              if layout.startswith("planar") else (torch.from_numpy(spec),))
    want = R.c2r_plain(*planes, n=n, layout=layout, scale=1.0 / L).numpy()
    assert np.abs(got - want).max() < 1e-9 * n
    assert np.abs(got - x).max() < 1e-9 * n


@pytest.mark.parametrize("n", REAL_N)
@pytest.mark.parametrize("layout", H.REAL_LAYOUTS)
def test_c2r_forms_every_point_once(rng, n, layout):
    """The threads' points t + s*TPF cover the row once, so each point of
    Z is formed once, in the registers of the thread whose first stage
    takes it; each bin of the input is read twice (as X[p] and as the
    mirror of L-p; bin 0 twice by its own thread), the numpy layout's DC
    and Nyquist bins 0 and L once: the bytes a call reads from device
    memory are the input's, the second read of a bin served by L2."""
    _, spec = spectrum_in(rng, n, layout, rows=1)
    _, formed, reads = H.c2r_rows(spec, layout)
    assert formed.shape == (n // 2,) and (formed == 1).all()
    want = np.full(spec.shape[1], 2)
    if layout == "numpy":
        want[[0, -1]] = 1
    assert (reads == want).all()


@pytest.mark.parametrize("in_natural", [True, False])
def test_c2r_model_matches_jax(rng, in_natural):
    """The C2R model against the JAX package's fused C2R
    (``pallas_real.irfft_fused_planar`` in interpret mode) on the same
    seeded spectrum, natural and revblock input, the raw contract (n/2)
    x."""
    import jax.numpy as jnp

    import smfft_tpu.ops.pallas_c2c as PC
    import smfft_tpu.ops.pallas_real as PR

    n = 1024
    L = n // 2
    layout = "planar" if in_natural else "planar_rev"
    _, spec = spectrum_in(rng, n, layout, rows=4)
    spec = spec.astype(np.complex64)
    PC.set_interpret(True)
    try:
        ref = np.asarray(PR.irfft_fused_planar(
            jnp.asarray(spec.real), jnp.asarray(spec.imag), n,
            in_natural=in_natural))
    finally:
        PC.set_interpret(False)
    got, _, _ = H.c2r_rows(spec.astype(complex), layout)
    assert np.abs(got - ref).max() < 2 * (5e-7 * n ** 0.75 * 8) * L


@pytest.mark.parametrize("table", ["twiddles", "split"])
def test_kernel_tables_are_made_once(table):
    """The wrappers' device tables are cached per size, direction, tier
    and device: a second call returns the same tensor, so no launch copies
    a table from the host."""
    dev = torch.device("cpu")
    make = ((lambda: OC.device_twiddles(512, True, False, dev))
            if table == "twiddles" else
            (lambda: R.split_table(1024, False, dev)))
    assert make() is make()


def test_c2c_packs_rows_at_32_and_64():
    """N = 32 / 64: 128 / 64 rows of 2 / 4 threads share a block of 256."""
    for m, rows in ((32, 128), (64, 64)):
        g = H.row_geometry(m)
        assert (g["F"], g["TPF"], g["threads"]) == (rows, 256 // rows, 256)


@pytest.mark.parametrize("radix", [8, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_anchored_powers(radix, inverse):
    """hcore.cuh's twiddle_anchored: every power w^r of a stage's twiddle
    from the two entries W^k and W^(4k), each at most three products from
    them."""
    s = 1 if inverse else -1
    for pr in (16 * radix, 256 * radix):
        for k in range(0, pr // radix, 7):
            w = np.exp(s * 2j * np.pi * k / pr)
            got = H.anchored_powers(w, w ** 4, radix)
            want = np.exp(s * 2j * np.pi * k * np.arange(radix) / pr)
            np.testing.assert_allclose(got, want, atol=1e-12)


# ---------------------------------------------------------------------------
# The reuse loops on the core: c2c_multiple_kernel and real_multiple_kernel.
# ---------------------------------------------------------------------------

MULTIPLE_N = [32, 64, 128, 256, 512, 1024, 2048, 4096]
HANDOFFS = [(fb, last, out) for fb in (False, True) for last in (False, True)
            for out in (False, True)]


@pytest.mark.parametrize("m", ROW_M)
def test_natural_handoff_keeps_the_register_layout(m):
    """The last stage leaves point t + s*TPF in register u[s] of thread t,
    the point the first stage reads from there: one transform's registers
    are the next one's input, with no shared-memory hand-off."""
    tpf = H.row_geometry(m)["TPF"]
    pts = H.last_stage_points(m, tpf)
    want = np.arange(tpf)[:, None] + np.arange(m // tpf)[None, :] * tpf
    assert (pts == want).all()


@pytest.mark.parametrize("m", MULTIPLE_N)
@pytest.mark.parametrize("loops", [0, 1, 2, 5])
@pytest.mark.parametrize("fb_rev,last_rev,rev_out", HANDOFFS)
def test_multiple_model_matches_plain(rng, m, loops, fb_rev, last_rev,
                                      rev_out):
    """c2c_multiple_kernel's hand-offs (natural in the registers, revblock
    through the staging), scales and output layouts give
    ``multiple_plain`` in float64, every hand-off combination and loop
    count, both directions."""
    inverse = fb_rev != rev_out
    x = rand_c(rng, 2, m)
    got = H.multiple_rows(x, loops, inverse, fb_rev, last_rev, rev_out, 0.5)
    pr, pi = MU.multiple_plain(torch.from_numpy(x.real.copy()),
                               torch.from_numpy(x.imag.copy()), loops=loops,
                               inverse=inverse, fb_rev=fb_rev,
                               last_rev=last_rev, rev_out=rev_out,
                               scale=0.5)
    assert np.abs(got - (pr.numpy() + 1j * pi.numpy())).max() < 1e-9 * m


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("pairs", [1, 2, 3])
def test_real_multiple_model_matches_plain(rng, n, pairs):
    """real_multiple_kernel's round trips (Z into the buffer unpadded, the
    pair split and merge in place, the inverse from the unpadded row) give
    ``real_multiple_plain`` in float64, and so x; every bin is written by
    one pair thread a round trip, so the in-place step needs no barrier
    between its reads and writes."""
    x = rng.random((2, n)) - 0.5
    got, hits = H.real_multiple_rows(x, pairs)
    want = MU.real_multiple_plain(torch.from_numpy(x), pairs).numpy()
    assert np.abs(got - want).max() < 1e-9 * n
    assert np.abs(got - x).max() < 1e-9 * n
    assert (hits == 1).all()


@pytest.mark.parametrize("kernel,m,exact",
                         [("c2c", m, ex) for m in ROW_M for ex in (False, True)]
                         + [("real", n // 2, False) for n in MULTIPLE_N[3:]])
def test_multiple_banks(kernel, m, exact):
    """What the reuse loops add to the core at the minimum wavefronts (2
    for 8-byte elements, 4 for 16-byte): the revblock hand-off's stores
    from the last stage and its reads by position; the real round trip's
    Z out, pair reads and writes (k ascending, L-k descending, unpadded),
    W_n^k, and the inverse's first stage from the unpadded row (the real
    loop has fp32 only)."""
    g = H.row_geometry(m, exact, H.REUSE_WARPS[kernel])
    pats = H.multiple_patterns(m, exact, kernel)
    kinds = {what for what, _ in pats}
    assert ({"hand-off: last stage", "hand-off: registers"} if kernel == "c2c"
            else {"pair k", "pair L-k", "W_n^k", "inverse: first stage"}) \
        <= kinds
    for what, w in pats:
        assert w <= g["elem"] // 4, (what, w)


# ---------------------------------------------------------------------------
# The fused convolutions on the core: conv_kernel and conv_real_kernel.
# ---------------------------------------------------------------------------

CONV_N = [32, 64, 128, 256, 512, 1024, 2048, 4096]
CONV_REAL_N = [256, 512, 1024, 2048, 4096, 8192]


def packed_response(rng, m, n):
    """m random rfft-style responses in the kernel's packed form: slot 0 =
    (Re H[0], Re H[L]), 1/L folded in (``ops.convolve`` does the same)."""
    L = n // 2
    hf = np.fft.rfft(rng.random((m, n)) - 0.5)
    return np.concatenate([hf.real[:, :1] + 1j * hf.real[:, L:],
                           hf[:, 1:L]], axis=1) / L


@pytest.mark.parametrize("n", CONV_N)
@pytest.mark.parametrize("m", [1, 2, 3])
def test_conv_model_matches_plain(rng, n, m):
    """conv_kernel's index maps (the product with H at the points the
    forward core's last stage leaves in the registers, the inverse core
    from them, the bank's m inverses) give ``conv_plain`` in float64."""
    x = rand_c(rng, 2, n)
    h = rand_c(rng, m, n) / n
    got = H.conv_rows(x, h)
    pr, pi = CV.conv_plain(*(torch.from_numpy(a.copy())
                             for a in (x.real, x.imag, h.real, h.imag)))
    assert np.abs(got - (pr.numpy() + 1j * pi.numpy())).max() < 1e-9 * n


def test_conv_epilogue_indexes_h_by_point(rng):
    """The epilogue's H is indexed by the point a register holds, t +
    s*TPF; indexed by the register slot s it gives other rows."""
    n = 1024
    x, h = rand_c(rng, 2, n), rand_c(rng, 1, n) / n
    right = H.conv_rows(x, h)
    wrong = H.conv_rows(x, h, h_at=lambda t, s: s + 0 * t)
    assert np.abs(wrong - right).max() > 1e-3


@pytest.mark.parametrize("n", CONV_REAL_N)
@pytest.mark.parametrize("m", [1, 2, 3])
def test_conv_real_model_matches_plain(rng, n, m):
    """conv_real_kernel's index maps (Z unpadded in the row, the pair
    split with W_n^k, the products and the merge in place, slot 0's two
    real products, the self-pair, the inverse from the row) give
    ``conv_real_plain`` in float64; one pair thread writes each bin, and
    only bins it read itself, so the pair step needs no barrier inside."""
    x = rng.random((2, n)) - 0.5
    pk = packed_response(rng, m, n)
    got, hits, own = H.conv_real_rows(x, pk)
    want = CV.conv_real_plain(torch.from_numpy(x),
                              torch.from_numpy(pk.real.copy()),
                              torch.from_numpy(pk.imag.copy())).numpy()
    assert np.abs(got - want).max() < 1e-9 * n
    assert (hits == 1).all() and own


CONV_INSTANCES = (
    [("conv", m, ex) for m in ROW_M for ex in (False, True)]
    + [("conv_real", n // 2, ex) for n in CONV_REAL_N + [16384]
       for ex in (False, True)])


@pytest.mark.parametrize("kernel,m,exact", CONV_INSTANCES)
def test_conv_banks(kernel, m, exact):
    """Every shared-memory access of a convolution block at the minimum
    wavefronts (2 for 8-byte elements, 4 for 16-byte): the core's stages,
    and for the real kernel Z out of the last stage, the pair step's reads
    and writes of k and L-k (unpadded, to L = 8192), W_n^k from the block
    table and the inverse's first stage from the unpadded row; the stage
    table."""
    real = kernel == "conv_real"
    g = H.conv_geometry(m, exact, real)
    pats = H.conv_patterns(m, exact, kernel)
    kinds = {what for what, _ in pats}
    if real:
        assert {"pair k", "pair L-k", "Z out: last stage",
                "inverse: first stage"} <= kinds
        assert ("W_n^k" in kinds) == g["wk_shared"]
    for what, w in pats:
        lim = ((16 if exact else 8) // 4 if what in ("tw", "W_n^k")
               else g["elem"] // 4)
        assert w <= lim, (what, w)


@pytest.mark.parametrize("kernel,m,exact", CONV_INSTANCES)
def test_conv_geometry(kernel, m, exact):
    """The chosen instantiations, single-filter and bank alike: the row
    kernels' blocks (256 threads to M = 4096, one row of 512 above) at 16
    warps an SM, fewer only where the shared memory says so, with two
    buffers a row below M = 8192; the block fits the 227 KB a block may
    use with the stage table and, for the real kernel, W_n^k, which only
    the "exact" tier at L = 8192 (139 KB row, 74 KB table) reads from
    device memory; one slot at M = 16384, where a second one does not
    fit."""
    real = kernel == "conv_real"
    g = H.conv_geometry(m, exact, real)
    assert g["threads"] == (256 if m <= 4096 else 512)
    assert g["smem"] <= 232448
    assert g["MINB"] * (g["smem"] + 1024) <= 233472
    assert g["MINB"] <= max(1, 16 * 32 // g["threads"])
    if m < 8192 and not exact:
        assert g["PP"] and g["MINB"] == 2
    assert g["wk_shared"] == (real and not (exact and m == 8192))
    if m == 16384:
        assert not g["PP"] and g["MINB"] == 1
