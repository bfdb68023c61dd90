"""The copy-out of a served view (``pipeline.HostSlots``, ``to_host``) and
the tracer's event count, on tiny CPU tensors: a slot from a plain
(unpinned) allocator takes the place of the card's page-locked one, so
every rule of the slots runs here. The card's own run of it is in
tests/test_torch_kernels.py (marked ``cuda``).
"""

import mmap

import numpy as np
import pytest
import torch

from eogs2_tpu_torch.observability import Tracer, span, tracer
from eogs2_tpu_torch.pipeline import HostSlots, to_host


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.enable(False)
    tracer.reset()
    yield
    tracer.enable(False)
    tracer.reset()


def plain(nbytes):
    return torch.empty(nbytes, dtype=torch.uint8)


def outputs(seed, h=20, w=24, shared=True, shadow=True):
    """render_view_full's eight outputs at a padded h x w: ``shaded`` and
    ``final`` one tensor (no PAN mode) where ``shared``; ``shadowmap`` None
    unless ``shadow``; ``acc_opacity`` not contiguous."""
    g = torch.Generator().manual_seed(seed)
    image = torch.randn((5, h, w), generator=g)
    shaded = torch.randn((3, h, w), generator=g)
    return {
        "raw_render": image[:3],
        "altitude": image[3],
        "acc_opacity": torch.randn((w, h), generator=g).t(),
        "cc": torch.randn((3, h, w), generator=g),
        "shaded": shaded,
        "final": shaded if shared else torch.randn((3, h, w), generator=g),
        "shadowmap": torch.rand((h, w), generator=g) if shadow else None,
        "rendered_uva": torch.randn((h, w, 3), generator=g),
    }


def slot_bytes(outs):
    """The slot a copy-out of ``outs`` takes: its bytes (each output's
    region a multiple of 256) to a power of two, at least a page."""
    n = sum(-(-x.numel() * 4 // 256) * 256 for x in outs.values()
            if x is not None)
    return max(1 << (n - 1).bit_length(), mmap.PAGESIZE)


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == v.dtype == np.float32, k
        assert got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def test_packed_copy_equals_plain_copy():
    """Packed into a slot, each output equals its own ``.cpu().numpy()``
    bit for bit, uncropped and cropped as render_view_full crops; a None
    output stays None."""
    slots = HostSlots(plain)
    for shadow in (True, False):
        outs = outputs(1, shadow=shadow)
        assert_same(slots.copy_out(outs),
                    {k: None if x is None else x.cpu().numpy()
                     for k, x in outs.items()})
        got = to_host(outs, 17, 22, slots)
        assert_same(got, to_host(outs, 17, 22))
        assert got["final"].shape == (3, 17, 22)
        assert got["altitude"].shape == (17, 22)
        assert got["rendered_uva"].shape == (17, 22, 3)


def test_kept_result_and_slice_are_unchanged_by_later_copy_outs():
    """A kept result, and a kept slice of another (its result dropped),
    read the same bits after three later copy-outs: neither slot is
    taken again."""
    slots = HostSlots(plain)
    kept = to_host(outputs(2), 20, 24, slots)
    want = {k: None if v is None else v.copy() for k, v in kept.items()}
    part = to_host(outputs(3), 20, 24, slots)["final"][1, 2:5]
    part_want = part.copy()
    for seed in (4, 5, 6):
        to_host(outputs(seed), 20, 24, slots)
    assert_same(kept, want)
    assert part.tobytes() == part_want.tobytes()
    assert part.tobytes() == outputs(3)["final"][1, 2:5].numpy().tobytes()


def test_dropped_result_slot_is_reused_and_counted():
    """A request whose arrays were all dropped frees its slot: the next
    takes it (counted reused), a request beside a kept one takes a new
    slot (counted new); one wait a request."""
    slots = HostSlots(plain)
    tracer.enable()
    first = slots.copy_out(outputs(7))
    base = first["raw_render"].base
    for seed in (8, 9):
        with span("serve.request", unit=True):
            out = slots.copy_out(outputs(seed))
        assert out["raw_render"].base is not base  # first is kept
        del out
    with span("serve.request", unit=True):
        slots.copy_out(outputs(10))
    del first, base
    with span("serve.request", unit=True):
        slots.copy_out(outputs(11))
    u = tracer.per_unit("serve.request")
    assert u["units"] == 4
    assert u["counts"] == {"serve.slot.new": 0.25, "serve.slot.reused": 0.75}
    assert u["sites"] == {"serve.to_host": 1.0}
    assert len(slots._slots) == 2


def test_past_the_cap_falls_back_with_equal_values():
    """Past the cap a request is not copied into a slot (counted fallback)
    and to_host takes one plain copy an output, with equal values; free
    slots too small for a larger request are dropped to make room."""
    outs = outputs(12, h=8, w=8)
    small = slot_bytes(outs)
    slots = HostSlots(plain, cap=2 * small)
    tracer.enable()
    with span("serve.request", unit=True):
        kept = [to_host(outs, 8, 8, slots) for _ in range(2)]
    with span("serve.request", unit=True):
        got = to_host(outs, 8, 8, slots)
    assert_same(got, to_host(outs, 8, 8))
    u = tracer.per_unit("serve.request")  # 2 units: 2 slots, then 8 copies
    assert u["counts"] == {"serve.slot.new": 1.0, "serve.slot.fallback": 0.5}
    assert u["sites"] == {"serve.to_host": (2 + 8) / 2}
    assert_same(kept[0], to_host(outs, 8, 8))
    del kept, got
    n = 8  # a request too large for either free slot, not for both
    while slot_bytes(outputs(13, h=n, w=n)) == small:
        n += 1
    big = outputs(13, h=n, w=n)
    assert slot_bytes(big) == 2 * small
    assert slots.copy_out(big) is not None
    assert [s[0].numel() for s in slots._slots] == [2 * small]


def test_shaded_and_final_are_separate_arrays():
    """``shaded`` and ``final`` of one tensor come back as two arrays:
    writing one leaves the other as it was."""
    outs = outputs(14)
    assert outs["shaded"] is outs["final"]
    got = to_host(outs, 20, 24, HostSlots(plain))
    assert not np.shares_memory(got["shaded"], got["final"])
    before = got["final"].copy()
    got["shaded"][:] = -7.0
    assert got["final"].tobytes() == before.tobytes()


def test_tracer_count_is_per_unit_and_off_records_nothing():
    """``Tracer.count`` adds under the current unit (``counts`` of
    ``per_unit``, a mean a unit), records nothing while the tracer is off,
    and leaves ``per_unit``'s other keys and ``summary`` as they were."""
    t = Tracer()
    t.count("x.ev")
    with t.span("u", unit=True):
        t.count("x.ev")
    assert t.per_unit("u") is None
    t.enable()
    with t.span("u", unit=True):
        t.host_read(torch.ones(1), "x.read")
        t.count("x.ev", 3)
    with t.span("u", unit=True):
        t.host_read(torch.ones(1), "x.read")
    t.count("x.ev")  # outside a unit
    u = t.per_unit("u")
    assert u["counts"] == {"x.ev": 1.5}  # 3 events over 2 units
    assert set(u) == {"units", "spans", "reads", "read_wait_ms", "sites",
                      "counts"}
    assert (u["units"], u["reads"], u["sites"]) == (2, 1.0, {"x.read": 1.0})
    assert set(u["spans"]) == {"u"}
    assert set(t.summary()) == {"units", "spans", "reads", "dropped"}
