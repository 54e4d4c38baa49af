"""The port's paged session slabs against the reference's, on the CPU.

The same allocation sequence must give the same page ids and high-water
marks, the port's ``PagedSessionStore`` must read back what the reference's
does under one sequence of store operations (and what the contiguous
``ArraySessionStore`` holds), and a slab-backed session of a port engine
(``device="cpu"``, ``backend="ref"``, D = 64, L = 16) must decode bit for bit
as the JAX ``backend="ref"`` one-shot decode. Mirrors the slab part of
``tests/test_serve_async.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.engine import ArraySessionStore as JStore
from repro.launch.slab import SymbolSlab as JSlab
from repro_torch.core.engine import ArraySessionStore
from repro_torch.launch.faults import CapacityError
from repro_torch.launch.slab import PagedSessionStore, SlabExhausted, SymbolSlab

from test_torch_serve_async import N_BITS, T_PAGE, bits_of, engine, stream, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alloc_free_sequence_equals_the_reference(seed):
    """LIFO free-list: the same random alloc/free sequence hands out the same
    page ids, keeps the same free-list and high-water mark, and zeroes."""
    port, ref = SymbolSlab(n_pages=12, page_stages=4, R=2), JSlab(n_pages=12, page_stages=4, R=2)
    rng = np.random.default_rng(seed)
    held = []
    for _ in range(200):
        if held and (rng.random() < 0.45 or port.pages_free == 0):
            page = held.pop(int(rng.integers(0, len(held))))
            port._data[page] = 3.0  # dirty: a free must zero it
            port.free(page)
            ref.free(page)
        else:
            a, b = port.alloc(), ref.alloc()
            assert a == b
            held.append(a)
        assert port._free == ref._free
        assert (port.high_water, port.pages_in_use) == (ref.high_water, ref.pages_in_use)
    assert np.all(port._data[port._free] == 0.0)


def test_slab_refusals_and_exhaustion():
    sl = SymbolSlab(n_pages=2, page_stages=8, R=2)
    assert issubclass(SlabExhausted, CapacityError)
    a = sl.alloc()
    with pytest.raises(ValueError, match="double free"):
        sl.free(a)
        sl.free(a)
    with pytest.raises(ValueError):
        sl.free(5)
    with pytest.raises(ValueError):
        SymbolSlab(0, 4, 2)
    store = sl.open_store()
    store.append(np.ones((16, 2)))  # fills both pages
    with pytest.raises(SlabExhausted, match="slab exhausted"):
        store.append(np.ones((1, 2)))
    assert len(store) == 16  # a refused append wrote nothing
    store.drop_prefix(8)  # one page back to the free-list
    store.append(np.ones((8, 2)))
    assert sl.pages_in_use == 2


@pytest.mark.parametrize("page_stages", [5, 7, 96])
def test_paged_store_equals_the_reference_store(page_stages):
    """Random append/grow/scatter/read/drop on the port's and the reference's
    paged stores and on the contiguous store: identical reads, page lists
    and slab occupancy."""
    rng = np.random.default_rng(page_stages)
    p_slab, r_slab = SymbolSlab(64, page_stages, 3), JSlab(64, page_stages, 3)
    port, ref, flat = p_slab.open_store(), r_slab.open_store(), ArraySessionStore(3)
    for _ in range(300):
        op = int(rng.integers(0, 4))
        if op == 0:
            rows = rng.normal(size=(int(rng.integers(0, 12)), 3)).astype(np.float32)
            for s in (port, ref, flat):
                s.append(rows)
        elif op == 1:
            n = int(rng.integers(0, 7))
            for s in (port, ref, flat):
                s.grow(n)
        elif op == 2 and len(flat):
            k = int(rng.integers(1, 5))
            si, sj = rng.integers(0, len(flat), k), rng.integers(0, 3, k)
            v = rng.normal(size=k).astype(np.float32)
            for s in (port, ref, flat):
                s.scatter(si, sj, v)
        elif op == 3 and len(flat):
            n = int(rng.integers(0, len(flat) + 1))
            for s in (port, ref, flat):
                s.drop_prefix(n)
        assert len(port) == len(ref) == len(flat)
        assert (port._pages, port._head) == (ref._pages, ref._head)
        lo = int(rng.integers(0, len(flat) + 1))
        n = int(rng.integers(0, len(flat) - lo + 3))  # deliberately over-reads
        np.testing.assert_array_equal(port.read(lo, n), ref.read(lo, n))
        np.testing.assert_array_equal(port.read(lo, n), flat.read(lo, n))
    assert p_slab.high_water == r_slab.high_water
    port.close()
    port.close()  # idempotent
    assert p_slab.pages_in_use == 0
    with pytest.raises(ValueError, match="closed"):
        port.append(np.zeros((1, 3)))


def test_snapshots_cross_between_the_packages():
    """A paged store's snapshot is logical content only: it restores into
    the reference's paged and contiguous stores and back, page-misaligned."""
    rows = np.random.default_rng(5).normal(size=(23, 2)).astype(np.float32)
    sl = SymbolSlab(n_pages=16, page_stages=5, R=2)
    p = sl.open_store()
    p.append(rows)
    p.drop_prefix(4)
    for target in (JSlab(16, 5, 2).open_store(), JStore(2), ArraySessionStore(2)):
        target.restore(p.snapshot())
        np.testing.assert_array_equal(np.asarray(target.read(0, len(target))), rows[4:])
    j = JSlab(16, 7, 2).open_store()
    j.append(rows)
    j.drop_prefix(4)
    back = sl.open_store()
    back.restore(j.snapshot())
    np.testing.assert_array_equal(back.read(0, len(back)), rows[4:])
    with pytest.raises(ValueError, match="not empty"):
        back.restore(p.snapshot())
    p.close()
    back.close()
    assert sl.pages_in_use == 0


@pytest.mark.parametrize("name", ["ccsds", "ccsds-3/4"])
def test_slab_backed_session_bit_exact_and_releases_pages(name):
    y = stream(name, N_BITS, 9)
    sl = SymbolSlab(n_pages=32, page_stages=T_PAGE, R=2)
    sess = engine(name).session(store=sl.open_store())
    assert isinstance(sess._store, PagedSessionStore)
    rng = np.random.default_rng(0)
    outs, pos = [], 0
    while pos < len(y):
        n = int(rng.integers(1, 150))
        outs.append(sess.decode(y[pos : pos + n]))
        pos += n
    outs.append(sess.finish(N_BITS))
    np.testing.assert_array_equal(bits_of(torch.cat(outs)), want([y], name=name)[0])
    assert 0 < sl.high_water <= 32
    sess.close()
    assert sl.pages_in_use == 0


def test_pre_quantized_int8_chunks_are_exact_in_the_float32_slab():
    """The slab stores float32; int8 chunks round-trip exactly and the
    session casts its window back to int8 on the way to the device."""
    y = stream("ccsds", N_BITS, 10)
    yq = np.clip(np.rint(y * 40.0), -127, 127).astype(np.int8)
    sl = SymbolSlab(n_pages=16, page_stages=T_PAGE, R=2)
    sess = engine().session(store=sl.open_store())
    outs = [sess.decode(c) for c in np.array_split(yq, 5)] + [sess.finish(N_BITS)]
    assert sess._int_dtype == np.int8
    np.testing.assert_array_equal(bits_of(torch.cat(outs)), want([yq])[0])
