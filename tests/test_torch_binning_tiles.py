"""The binning kernel's tile schedule (``csrc/bin_xyzw.cu``) rehearsed in
plain torch, and its scratch layout (``ops/cuda_binning.py:scratch_layout``).

The kernel sorts the live rays by image tile (a tile is ``TILE`` consecutive
pixel keys), cuts each tile's segment into work items of at most ``CHUNK``
rays, sums each item's integers, writes a tile of one item directly and
combines the items of a split tile before it writes. ``_tile_schedule``
below does the same steps on the CPU, with the rays placed in each segment
in a shuffled order (on the card that order varies from run to run), and
its image must equal ``bin_xyzw_fixed``'s bit for bit on the edge inputs of
``_edge_inputs``: all of them at the kernel's own constants and at a small
tile and chunk that split many tiles. The bookkeeping must also stay inside
the bounds the scratch is sized for. The same inputs go through the
kernel on the card (``cuda`` marker; ``python3 chip_smoke.py`` is the full
on-card check).

The plain version itself is held against the JAX package's binning in
tests/test_torch_binning_fixed.py; the schedule's image here is exact, so
no tolerance is stated.
"""

import numpy as np
import pytest
import torch

from optrace_tpu_torch.color.observers import x_observer, y_observer, z_observer
from optrace_tpu_torch.ops.binning import binning_indices_2d, bin_xyzw_fixed, fixed_point_exponent, pow2
from optrace_tpu_torch.ops.cuda_binning import (CHUNK, MAX_PIXELS, MAX_RAYS, TILE, bin_xyzw_cuda,
                                                scratch_layout)

EXT = (-1.0, 1.0, -1.0, 1.0)
SMALL = (64, 32)        # a tile and chunk that split many tiles at a few thousand rays


def _tile_schedule(px, py, w, wl, Nx, Ny, extent, tile, chunk, out=None, seed=0):
    """The kernel's passes in plain torch; returns (image, bookkeeping)."""
    P = Nx * Ny
    lay = scratch_layout(px.shape[0], Nx, Ny, tile, chunk)
    # pass 1: keys, live rays, tile counts; max|w| over all rays
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    live = wm != 0
    key = (yi * Nx + xi)[live]
    T = lay["tiles"]
    count = torch.bincount(key // tile, minlength=T)
    assert count.shape[0] == T
    e = fixed_point_exponent(w)
    # plan: each tile's segment and its work items {tile, first record,
    # records, split slot or None}; a split tile counts its items still to come
    cursor = torch.cumsum(count, 0) - count
    n_items = (count + chunk - 1) // chunk
    items, to_come = [], {}
    for t in range(T):
        n, c, start = int(n_items[t]), int(count[t]), int(cursor[t])
        slot = len(to_come) if n > 1 else None
        if n > 1:
            to_come[slot] = n
        items += [(t, start + j * chunk, min(chunk, c - j * chunk), slot) for j in range(n)]
    # scatter: each live ray becomes a record in its tile's segment, in an
    # order inside the segment that changes from run to run
    perm = torch.randperm(key.shape[0], generator=torch.Generator().manual_seed(seed))
    order = perm[torch.argsort(key[perm] // tile, stable=True)]
    rec_key = key[order]
    vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)[live]
    rec_q = torch.round(vals[order].to(torch.float64) * pow2(e)).to(torch.int64)
    assert torch.equal(rec_key // tile, torch.repeat_interleave(torch.arange(T), count))
    # sums: items in a shuffled order; a split tile's items add into its
    # slot and the last of them to arrive writes the tile
    img = torch.zeros((P, 4), dtype=torch.float32) if out is None else out.view(P, 4)
    inv = pow2(-e)
    slots = {k: torch.zeros((tile, 4), dtype=torch.int64) for k in to_come}
    sizes = []

    def write(t, sums):
        p = torch.arange(tile) + t * tile
        lit = sums != 0
        assert not lit[p >= P].any()        # no key beyond the image
        conv = (sums.to(torch.float64) * inv).to(torch.float32)
        rows = img[p[p < P]]
        img[p[p < P]] = torch.where(lit[p < P], rows + conv[p < P], rows)

    for k in torch.randperm(len(items), generator=torch.Generator().manual_seed(seed + 1)).tolist():
        t, start, size, slot = items[k]
        sizes.append(size)
        sums = torch.zeros((tile, 4), dtype=torch.int64)
        sums.index_add_(0, rec_key[start:start + size] - t * tile, rec_q[start:start + size])
        if slot is None:
            write(t, sums)
        else:
            slots[slot] += sums
            to_come[slot] -= 1
            if to_come[slot] == 0:
                write(t, slots[slot])
    assert not any(to_come.values())
    book = dict(items=len(items), splits=len(slots), records=int(key.shape[0]),
                largest_item=max(sizes, default=0), smallest_item=min(sizes, default=1),
                tiles_lit=int((count > 0).sum()), layout=lay)
    return img.view(Ny, Nx, 4), book


def _centres(keys, Nx, Ny):
    """Positions of the centres of pixels ``keys`` over EXT (f32)."""
    keys = np.asarray(keys)
    x = EXT[0] + (keys % Nx + 0.5) * (EXT[1] - EXT[0]) / Nx
    y = EXT[2] + (keys // Nx + 0.5) * (EXT[3] - EXT[2]) / Ny
    return x.astype(np.float32), y.astype(np.float32)


def _edge_inputs(tile, chunk):
    """name -> (px, py, w, wl, Nx, Ny) as numpy f32, made from seeds, sized
    for a schedule of ``tile`` pixels and ``chunk`` rays."""
    rng = np.random.default_rng(3)

    def rays(x, y, seed):
        r = np.random.default_rng(seed)
        n = len(x)
        return (np.asarray(x, np.float32), np.asarray(y, np.float32),
                r.uniform(0.05, 1.0, n).astype(np.float32), r.uniform(370, 790, n).astype(np.float32))

    cases = {}
    # every ray in one pixel, more rays than two work items
    Nx, Ny = 63, 57
    x, y = _centres(np.full(2 * chunk + chunk // 2, 1234 % (Nx * Ny)), Nx, Ny)
    cases["one_pixel"] = (*rays(x, y, 1), Nx, Ny)
    # rays on the first and last pixel of every other tile, the tiles
    # between them empty; the pixel count no multiple of the tile
    side = int(np.ceil(np.sqrt(6.3 * tile)))
    Nx, Ny = side, side + 1
    P = Nx * Ny
    assert P % tile != 0
    firsts = np.arange(0, P, 2 * tile)
    keys = np.concatenate([firsts, np.minimum(firsts + tile - 1, P - 1), [P - 1]])
    keys = np.repeat(keys, 7)
    x, y = _centres(keys, Nx, Ny)
    cases["tile_edges"] = (*rays(x, y, 2), Nx, Ny)
    # spread rays over a pixel count that is no multiple of the tile
    Nx, Ny = 45, int(np.ceil(tile / 45)) + 2
    n = 3000
    cases["ragged"] = (*rays(rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), 3), Nx, Ny)
    # an image smaller than one tile
    cases["small_image"] = (*rays(rng.uniform(-1.1, 1.1, 500), rng.uniform(-1.1, 1.1, 500), 4), 16, 16)
    # one ray
    cases["one_ray"] = (*rays([0.3], [-0.2], 5), 31, 29)
    # no live ray: outside the extent, beyond its edges, or of weight 0
    x = np.array([1.5, -1.0000001, 0.5, 0.0, 2.0, -3.0], np.float32)
    y = np.array([0.0, 0.2, 1.0000001, 0.0, 2.0, 0.1], np.float32)
    px, py, w, wl = rays(x, y, 6)
    w[3] = 0.0
    cases["no_live"] = (px, py, w, wl, 31, 29)
    # rays outside the extent and on its inclusive edges (x = x1, y = y1 go
    # to the last column and row, x = x0 to the first)
    e = np.array([-1.0, 1.0, 0.0, 1.0, -1.0, 1.0000001, -1.0000001, 0.7], np.float32)
    f = np.array([0.0, 0.0, 1.0, 1.0, -1.0, 0.3, 0.3, -1.0], np.float32)
    x = np.concatenate([e, f, rng.uniform(-1.2, 1.2, 400)]).astype(np.float32)
    y = np.concatenate([f, e, rng.uniform(-1.2, 1.2, 400)]).astype(np.float32)
    cases["edges"] = (*rays(x, y, 7), 47, 41)
    # a tile of several work items beside tiles of one: rays over the pixels
    # of the first tile, and a few elsewhere
    Nx, Ny = 97, int(np.ceil(3 * tile / 97))
    keys = np.concatenate([rng.integers(0, tile, 3 * chunk + 5), rng.integers(tile, Nx * Ny, 50)])
    x, y = _centres(keys, Nx, Ny)
    cases["split"] = (*rays(x, y, 8), Nx, Ny)
    return cases


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _base(Ny, Nx, device="cpu"):
    """An image that holds values already, -0.0 among them: a channel whose
    sum is 0 must keep its bits."""
    base = torch.full((Ny, Nx, 4), 0.25, dtype=torch.float32, device=device)
    base[::3, ::2, 1] = -0.0
    return base


EDGE_NAMES = list(_edge_inputs(*SMALL))


@pytest.mark.parametrize("tile, chunk", [(TILE, CHUNK), SMALL], ids=["kernel", "small"])
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_schedule_equals_plain_version(name, tile, chunk):
    px, py, w, wl, Nx, Ny = (_t(a) if isinstance(a, np.ndarray) else a for a in _edge_inputs(tile, chunk)[name])
    ref = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, EXT)
    img, book = _tile_schedule(px, py, w, wl, Nx, Ny, EXT, tile, chunk)
    assert torch.equal(img.view(torch.int32), ref.view(torch.int32))
    # another order inside the segments and of the items: the same bits
    img2, _ = _tile_schedule(px, py, w, wl, Nx, Ny, EXT, tile, chunk, seed=5)
    assert torch.equal(img2.view(torch.int32), img.view(torch.int32))
    # into an image that holds values
    acc, _ = _tile_schedule(px, py, w, wl, Nx, Ny, EXT, tile, chunk, out=_base(Ny, Nx))
    acc_ref = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, EXT, out=_base(Ny, Nx))
    assert torch.equal(acc.view(torch.int32), acc_ref.view(torch.int32))
    # the bookkeeping inside the bounds the scratch is sized for
    lay = book["layout"]
    assert book["items"] <= lay["items_max"] and book["splits"] <= lay["splits_max"]
    assert book["records"] <= px.shape[0] and book["largest_item"] <= chunk
    assert book["smallest_item"] >= 1


@pytest.mark.parametrize("tile, chunk", [(TILE, CHUNK), SMALL], ids=["kernel", "small"])
def test_edge_inputs_take_the_ways_they_name(tile, chunk):
    cases = _edge_inputs(tile, chunk)
    books = {}
    for name, (px, py, w, wl, Nx, Ny) in cases.items():
        _, books[name] = _tile_schedule(_t(px), _t(py), _t(w), _t(wl), Nx, Ny, EXT, tile, chunk)
    assert books["one_pixel"]["tiles_lit"] == 1 and books["one_pixel"]["items"] == 3
    assert books["one_pixel"]["splits"] == 1
    lay = books["tile_edges"]["layout"]
    assert books["tile_edges"]["tiles_lit"] < lay["tiles"]          # empty tiles between lit ones
    assert lay["tiles"] * tile > cases["tile_edges"][4] * cases["tile_edges"][5]
    assert cases["ragged"][4] * cases["ragged"][5] % tile != 0
    assert books["small_image"]["layout"]["tiles"] == -(-16 * 16 // tile)      # 1 at the kernel's tile
    assert books["one_ray"]["records"] == 1 and books["one_ray"]["items"] == 1
    assert books["no_live"]["records"] == 0 and books["no_live"]["items"] == 0
    assert 0 < books["edges"]["records"] < cases["edges"][0].shape[0]
    assert books["split"]["splits"] == 1 and books["split"]["items"] == 4 + books["split"]["tiles_lit"] - 1
    assert books["split"]["largest_item"] == chunk


def test_edge_coordinates_land_on_the_last_pixel():
    # x = x1 and y = y1 are inside (the last column and row), a hair beyond is not
    px, py, w, wl = (_t(np.array(a, np.float32)) for a in ([1.0, 1.0000001, -1.0], [1.0, 0.0, -1.0],
                                                             [1.0, 1.0, 1.0], [550.0, 550.0, 550.0]))
    img = bin_xyzw_fixed(px, py, w, wl, 5, 4, EXT)
    assert float(img[3, 4, 3]) == 1.0 and float(img[0, 0, 3]) == 1.0 and float(img[..., 3].sum()) == 2.0


@pytest.mark.parametrize("N, Nx, Ny", [(0, 1, 1), (1, 16, 16), (10 ** 6, 945, 945), (12345, 189, 315),
                                       (4097, 2048, 1), (2 ** 31 - 1, 8192, 8192)])
def test_scratch_layout(N, Nx, Ny):
    lay = scratch_layout(N, Nx, Ny)
    assert lay == scratch_layout(N, Nx, Ny)         # a function of (N, Nx, Ny) alone
    parts = ["head", "count", "cursor", "items", "arrive", "records", "split", "total"]
    offs = [lay[p] for p in parts]
    assert all(o % 16 == 0 for o in offs) and lay["zeroed"] % 16 == 0
    assert offs == sorted(offs) and lay["head"] == 0 and lay["zeroed"] == lay["cursor"]
    T = -(-Nx * Ny // TILE)
    assert lay["tiles"] == T and lay["cursor"] - lay["count"] >= 4 * T
    assert lay["items"] - lay["cursor"] >= 4 * T
    assert lay["arrive"] - lay["items"] == 16 * lay["items_max"] >= 16 * (T + N // CHUNK)
    assert lay["split"] - lay["records"] == 16 * N
    assert lay["total"] - lay["split"] == lay["splits_max"] * TILE * 32
    # a split tile holds more than CHUNK rays: at most N // (CHUNK + 1) of them
    assert lay["splits_max"] == min(N // (CHUNK + 1), T)
    # no (Ny·Nx, 4) int64 image: beyond the rays' records the scratch grows
    # with the tiles and with N / CHUNK, not with the pixels
    assert lay["records"] <= 64 * T + 16 * (N // CHUNK) + 64


def test_scratch_layout_refuses_past_the_index_widths():
    with pytest.raises(ValueError):
        scratch_layout(MAX_RAYS + 1, 945, 945)
    with pytest.raises(ValueError):
        scratch_layout(10, 2 ** 15, 2 ** 14)            # 2^29 pixels
    with pytest.raises(ValueError):
        scratch_layout(10, 0, 5)
    with pytest.raises(ValueError):
        scratch_layout(-1, 5, 5)
    assert scratch_layout(10, MAX_PIXELS, 1)["tiles"] == -(-MAX_PIXELS // TILE)


def test_cpu_tensors_take_the_f32_reference():
    px, py, w, wl, Nx, Ny = _edge_inputs(*SMALL)["ragged"]
    from optrace_tpu_torch.ops.binning import bin_xyzw
    before = bin_xyzw_cuda.launches
    img = bin_xyzw_cuda(_t(px), _t(py), _t(w), _t(wl), Nx, Ny, EXT)
    assert bin_xyzw_cuda.launches == before
    assert torch.equal(img, bin_xyzw(_t(px), _t(py), _t(w), _t(wl), Nx, Ny, EXT))


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the binning kernel has no CPU route)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_kernel_equals_plain_version_on_the_card(card, name):
    px, py, w, wl, Nx, Ny = (_t(a, card) if isinstance(a, np.ndarray) else a
                             for a in _edge_inputs(TILE, CHUNK)[name])
    before = bin_xyzw_cuda.launches
    img = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, EXT)
    img2 = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, EXT)
    acc = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, EXT, out=_base(Ny, Nx, card))
    torch.cuda.synchronize()
    assert bin_xyzw_cuda.launches == before + 3
    ref = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, EXT)
    acc_ref = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, EXT, out=_base(Ny, Nx, card))
    for a, b in ((img, ref), (img2, ref), (acc, acc_ref)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_library_scratch_bytes_equal_the_layout(card):
    from optrace_tpu_torch.ops.cuda_binning import _lib
    lib = _lib()
    for N, Nx, Ny in ((1, 16, 16), (10 ** 6, 945, 945), (12345, 189, 315), (4097, 2048, 1)):
        assert lib.bin_xyzw_tiles_scratch_bytes(N, Nx * Ny) == scratch_layout(N, Nx, Ny)["total"]


@pytest.mark.cuda
def test_kernel_beyond_the_shared_counters_and_into_an_unaligned_image(card):
    """More tiles than a block counts in shared memory (the library's
    BIN_HIST_MAX), where counts and places are taken on the device counters
    directly, with a split tile among them; and an image 4 bytes past a
    16-byte boundary, which the kernel reads and writes a float at a time."""
    import ctypes
    from optrace_tpu_torch.ops.cuda_binning import _lib
    config = (ctypes.c_longlong * 4)()
    _lib().bin_xyzw_tiles_config(config)
    Nx, Ny = 4200, 4000
    assert -(-Nx * Ny // TILE) > config[3]
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-1.1, 1.1, 30000), np.full(CHUNK + 900, 0.3)]).astype(np.float32)
    y = np.concatenate([rng.uniform(-1.1, 1.1, 30000), np.full(CHUNK + 900, -0.7)]).astype(np.float32)
    w = rng.uniform(0.05, 1.0, x.shape[0]).astype(np.float32)
    wl = rng.uniform(370, 790, x.shape[0]).astype(np.float32)
    px, py, w, wl = (_t(a, card) for a in (x, y, w, wl))
    img = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, EXT)
    assert torch.equal(img.view(torch.int32), bin_xyzw_fixed(px, py, w, wl, Nx, Ny, EXT).view(torch.int32))
    del img
    px, py, w, wl, Nx, Ny = (_t(a, card) if isinstance(a, np.ndarray) else a
                             for a in _edge_inputs(TILE, CHUNK)["split"])
    buf = torch.full((Ny * Nx * 4 + 1,), 0.25, dtype=torch.float32, device=card)
    out = buf[1:].view(Ny, Nx, 4)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    bin_xyzw_cuda(px, py, w, wl, Nx, Ny, EXT, out=out)
    ref = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, EXT, out=torch.full((Ny, Nx, 4), 0.25, device=card))
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32)) and float(buf[0]) == 0.25
