"""The readers of the program's spans and host-read counters
(``benchmark/metrics/{emission_ms,resample_ms,host_reads,read_wait_ms,
to_host_ms}.*``) on the tiny CPU harness: each prints a number in a
``--trace 1`` run, within what the traced units can hold, and none in a
``--trace 0`` run."""

import pytest

from tiny import make_root, run_cell

READERS = {
    "train": ("emission_ms.train", "resample_ms.train", "host_reads.train",
              "read_wait_ms.train"),
    "render": ("emission_ms.render", "to_host_ms.render",
               "host_reads.render", "read_wait_ms.render"),
}


@pytest.mark.parametrize("kind", ["train", "render"])
def test_span_readers_print_a_number(tmp_path, capsys, kind):
    from eogs2_tpu_torch.observability import tracer

    root = make_root(str(tmp_path))
    tracer.reset()
    rc, res, err = run_cell(root, f"tiny.{kind}", capsys, trace=1)
    assert rc == 0, err
    m = res["metrics"]
    for name in READERS[kind]:
        assert name in m, (name, sorted(m))
        assert m[name]["value"] > 0, name
    reads = m[f"host_reads.{kind}"]["value"]
    # the fused route with tile cull: at least the demand and two masks of
    # every render (three a step, two a request)
    assert reads >= (9 if kind == "train" else 6)
    if kind == "render":  # and the eight outputs' copies
        assert reads >= 14
    assert res["correct"]
    tracer.reset()
    rc, res, _ = run_cell(root, f"tiny.{kind}", capsys, trace=0)
    assert rc == 0 and not set(READERS[kind]) & set(res["metrics"])
