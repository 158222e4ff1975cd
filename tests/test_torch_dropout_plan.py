"""The dropout kernel's launch plan (``cuda_dropout.launch_plan``), the
part of ``csrc/dropout.cu`` that runs on the host: for many sizes, the
16-byte accesses and the tail that the plan's grid walks write every
element exactly once, a tensor one wave of blocks covers takes one pass,
and a tensor of 2^32 elements or more is cut on 2^32 boundaries, each
piece's index high word added to the seed once.

``_writes`` walks the grid as the kernel does (``dropout_kernel``'s
loop and tail), so the plan's numbers are checked against the walk. The
kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import cuda_dropout as cd

FULL = {1: 8, 2: 8, 4: 8}   # 256 threads: eight blocks fill an SM


def _writes(plan, n):
    """How often the kernel under ``plan`` writes each of the n elements:
    block b of piece p takes chunks b, b + blocks, ... of THREADS * units
    accesses; a thread's accesses are its first one c (chunk * THREADS *
    units + t), while c < nvec, and c + u * THREADS below nvec; block 0's
    first threads write the piece's last n % elems elements."""
    hits = np.zeros(n, np.int64)
    chunk = cd.THREADS * plan.units
    t = np.arange(cd.THREADS)
    c0 = (np.arange(plan.blocks)[:, None] * chunk + t).ravel()
    passes = 0
    for p in range(plan.pieces):
        base = p * cd.PIECE
        length = min(n - base, cd.PIECE)
        nvec = length // plan.elems
        c = c0
        while (c < nvec).any():
            passes += 1
            live = c[c < nvec]
            for u in range(plan.units):
                v = live + u * cd.THREADS
                v = v[v < nvec]
                e = base + v[:, None] * plan.elems + np.arange(plan.elems)
                np.add.at(hits, e.ravel(), 1)
            c = c + plan.blocks * chunk
        tail = length - nvec * plan.elems
        np.add.at(hits, base + nvec * plan.elems + t[t < tail], 1)
    return hits, passes


SIZES = [1, 3, 7, 8, 9, 15, 16, 17, 255, 4095, 4096, 4097, 64 * 4096,
         1120 * 650, 35 * 32 * 650 + 5, 4096 * 768, 1 << 20]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [132, 2])
def test_plan_writes_every_element_once(itemsize, aligned, sms):
    """Every size, on the H100's 132 SMs and on 2 (where the larger
    sizes loop over chunks): each element written once."""
    for n in SIZES:
        plan = cd.launch_plan(n, itemsize, aligned, sms, FULL)
        assert plan.elems == (16 // itemsize if aligned else 1)
        assert plan.vector == aligned and plan.pieces == 1
        assert plan.units in cd.UNITS and plan.blocks >= 1
        hits, _ = _writes(plan, n)
        assert (hits == 1).all(), (n, plan)


@pytest.mark.parametrize("n", [1, 7, 4097, 64 * 4096, 1120 * 650,
                               4096 * 768, 1 << 24, 1 << 26])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_one_pass_when_a_wave_covers(n, itemsize):
    """The fewest accesses a thread for which one wave of blocks covers
    the vectors, and then no thread loops; past four accesses a thread
    the grid is one wave and loops."""
    plan = cd.launch_plan(n, itemsize, True, 132, FULL)
    wave = 132 * FULL[plan.units]
    nvec = n // plan.elems
    covers = plan.blocks * cd.THREADS * plan.units >= nvec
    assert plan.blocks <= wave
    if covers:
        smaller = [u for u in cd.UNITS if u < plan.units]
        assert all(-(-nvec // (cd.THREADS * u)) > 132 * FULL[u]
                   for u in smaller)
        if n <= 1 << 22:
            assert _writes(plan, n)[1] == min(nvec, 1)
    else:
        assert plan.units == 4 and plan.blocks == wave


def test_plan_at_the_main_paths_shapes():
    """On an H100 (132 SMs, eight blocks an SM): VGG's (64, 4096) f32
    and PTB's (1120, 650) f32 one access a thread, BERT's (4096, 768)
    bf16 two, each in one pass of fewer blocks than a wave."""
    for shape, itemsize, units, blocks in (((64, 4096), 4, 1, 256),
                                           ((1120, 650), 4, 1, 711),
                                           ((4096, 768), 2, 2, 768)):
        plan = cd.launch_plan(shape[0] * shape[1], itemsize, True, 132, FULL)
        assert (plan.units, plan.blocks) == (units, blocks)


def test_occupancy_sizes_the_wave():
    """Fewer resident blocks an SM give a smaller wave, so more accesses
    a thread."""
    n = 4096 * 768
    assert cd.launch_plan(n, 2, True, 132, FULL).units == 2
    assert cd.launch_plan(n, 2, True, 132, {1: 8, 2: 2, 4: 2}).units == 4
    assert cd.launch_plan(n, 2, True, 132, {1: 8, 2: 2, 4: 1}).blocks == 132


@pytest.mark.parametrize("n,pieces", [
    ((1 << 32) - 1, 1), (1 << 32, 1), ((1 << 32) + 1, 2),
    ((1 << 32) + 4096, 2), (3 * (1 << 32) + 5, 4)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_pieces_split_on_2_32(n, pieces, itemsize):
    """The pieces tile [0, n) on 2^32 boundaries; 2^32 is a whole number
    of accesses, so no access straddles one and only the last piece has
    a tail; an element's bits are the hash of its index's low word under
    the seed plus its piece, as the plain version's."""
    plan = cd.launch_plan(n, itemsize, True, 132, FULL)
    assert plan.pieces == pieces and cd.PIECE % plan.elems == 0
    starts = [p * cd.PIECE for p in range(pieces)]
    ends = [min(s + cd.PIECE, n) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e == s for e, s in zip(ends, starts[1:]))
    assert all((e - s) % plan.elems == 0 for s, e in zip(starts, ends[:-1]))
    seed = torch.tensor(2 ** 31 - 7)
    for i in (cd.PIECE - 2, cd.PIECE - 1, cd.PIECE, cd.PIECE + 1, n - 1):
        if i >= n:
            continue
        p, e = i // cd.PIECE, i % cd.PIECE
        idx = torch.tensor(i)
        want = cd.hash_bits(idx & cd._M32, (seed + (idx >> 32)) & cd._M32)
        got = cd.hash_bits(torch.tensor(e), (seed + p) & cd._M32)
        assert int(got) == int(want)
