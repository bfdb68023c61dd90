"""The port's tracer (``eogs2_tpu_torch/observability.py``): spans at the
stage boundaries of the training step and of view serving, and the
counters of the reads from the device to the host.

Off, a step records nothing, and makes no profiler annotation, no CUDA
event and no read beyond the plain ones. On (``Tracer.enable``, or while a
``torch.profiler`` profile is active), the spans nest under the step with
its iteration as their unit, the backward's spans (run on autograd's
engine thread) under ``train.backward``, and each read is counted at its
site. All on the CPU, at a tiny scene, torch on one thread.
"""

import collections
import json
import time

import pytest
import torch

import eogs2_tpu_torch.config as tconfig
from eogs2_tpu_torch import observability as obs
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.data.synthetic import make_scene_arrays, scene_from_arrays
from eogs2_tpu_torch.observability import Tracer, host_read, span, tracer
from eogs2_tpu_torch.pipeline import render_view_full
from eogs2_tpu_torch.rasterizer import RasterizeConfig

RENDERS_A_STEP = 3  # main, sun, random camera
# every wait of a fused step with tile cull for the card, by site: 16, as
# many as the card's sync debug mode reports in such a step
# (scripts/sync_audit.py)
CARD_SITES = {"emit.total": 3, "raster.scale_ndc": 3, "camera.row_scale": 3,
              "camera.inter_shift": 3, "camera.sun_scale": 1,
              "train.bg_zero": 1, "resample.longest_run": 2}


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


@pytest.fixture(scope="module")
def trainer():
    """A baseogs Trainer on the fused route with tile cull, sun and random
    camera from step 1, at 3 views of 32^2."""
    scene = scene_from_arrays(make_scene_arrays(
        n_views=3, width=32, height=32, hf_res=64, n_buildings=2, seed=0,
        scale=12.0), device="cpu")
    cfg = tconfig.baseogs(iterations=50)
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    tr = tt.Trainer(cfg, scene, RasterizeConfig(binning_mode="fused",
                                                tile_cull=True),
                    device="cpu").setup()
    tr.it = 0
    return tr


def step(tr):
    tr.it += 1
    return tr.train_step(tr.it)


def test_off_records_nothing(trainer, monkeypatch):
    """Off, a step makes no annotation, creates no CUDA event, reads no
    clock of the tracer's, records nothing, and reads from the device
    exactly what it reads on (the tracer adds no read)."""
    made = collections.Counter()

    def counting(name, real):
        def f(*a, **k):
            made[name] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function",
                                 torch.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event", counting("event", object))
    monkeypatch.setattr(torch.Tensor, "tolist",
                        counting("tolist", torch.Tensor.tolist))
    monkeypatch.setattr(torch.Tensor, "cpu", counting("cpu", torch.Tensor.cpu))

    class Clock:
        def perf_counter_ns(self):
            made["clock"] += 1
            return time.perf_counter_ns()

    monkeypatch.setattr(obs, "time", Clock())
    assert span("train.step") is span("train.step")  # one shared no-op
    step(trainer)
    off = dict(made)
    assert not off.get("record_function") and not off.get("event")
    assert not off.get("clock")
    assert tracer.summary() == dict(units={}, spans={}, reads={}, dropped=0)
    tracer.enable()
    step(trainer)
    assert made["tolist"] == 2 * off["tolist"]
    assert made["cpu"] == 2 * off["cpu"]
    assert made["clock"] > 0 and not made["record_function"]


def test_spans_nest_under_the_step(trainer, tmp_path):
    tracer.enable()
    step(trainer)
    tracer.dump(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)["spans"]
    by_id = {s["id"]: s for s in spans}

    def parent(s):
        return by_id[s["parent"]]["name"] if s["parent"] is not None else None

    [unit] = [s for s in spans if s["name"] == "train.step"]
    assert all(s["unit"] == "train.step" and s["unit_id"] == trainer.it
               for s in spans)
    # a one-modality (MSI) step opens its one modality span
    assert [s["name"] for s in spans
            if s["name"].startswith("train.forward.")] == ["train.forward.msi"]
    want = {"train.forward": "train.step", "train.backward": "train.step",
            "train.optimizer": "train.step",
            "train.maintenance": "train.step",
            "train.forward.msi": "train.forward",
            "raster.preprocess": "train.forward.msi",
            "raster.emission": "train.forward.msi",
            "raster.blend": "train.forward.msi",
            "resample": "train.forward.msi",
            "raster.blend_bwd": "train.backward",
            "resample.bwd": "train.backward"}
    for s in spans:
        if s["name"] in want:
            assert parent(s) == want[s["name"]], s
            assert unit["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= unit["t1_ns"]


def test_engine_thread_spans_take_the_waiting_span_as_parent():
    """On the card autograd runs a backward on its own thread (on the CPU
    on the caller's): a span opened there takes the span the unit's thread
    waits in as parent, and the unit as its own."""
    import threading

    tr = Tracer()
    tr.enable()
    with tr.span("train.step", unit=7):
        with tr.span("train.backward"):
            t = threading.Thread(target=lambda: tr.span("raster.blend_bwd")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by_name = {s["name"]: s for s in tr.spans()}
    bwd = by_name["raster.blend_bwd"]
    assert bwd["thread"] != by_name["train.step"]["thread"]
    assert bwd["parent"] == by_name["train.backward"]["id"]
    assert (bwd["unit"], bwd["unit_id"]) == ("train.step", 7)


def test_self_time_is_duration_less_children():
    tr = Tracer()
    tr.enable()
    with tr.span("outer", unit=True):
        time.sleep(0.002)
        for _ in range(2):
            with tr.span("inner"):
                time.sleep(0.003)
    spans = tr.spans()
    s = tr.summary(spans)["spans"]["outer"]
    inner = sum(x["host_ms"] for x in spans if x["name"] == "inner")
    assert s["outer"]["count"] == 1 and s["inner"]["count"] == 2
    assert s["outer"]["self_ms"] == pytest.approx(
        s["outer"]["host_ms"] - inner)
    assert s["outer"]["self_ms"] >= 1.5 and s["inner"]["self_ms"] >= 5.5
    assert tr.summary()["units"] == {"outer": 1}


def test_emission_once_per_render_and_reads_by_site(trainer):
    tracer.enable()
    for _ in range(2):
        step(trainer)
    u = tracer.per_unit("train.step")
    assert u["units"] == 2
    for name in ("raster.preprocess", "raster.emission", "raster.blend",
                 "raster.blend_bwd"):
        assert u["spans"][name]["count"] == RENDERS_A_STEP, name
    assert u["spans"]["resample"]["count"] == 2
    assert u["spans"]["resample.bwd"]["count"] == 2
    # the card's 16 waits; on the CPU also the plain preprocess's constants
    # (one a render, one more at the main render: 20 with the card's), the
    # plain emission's two cull masks and the plain blends' ranges
    assert sum(CARD_SITES.values()) == 16
    assert u["sites"] == dict(CARD_SITES, **{"projection.px": 3,
                                             "raster.px_scale": 1,
                                             "emit.cull_gid": 3,
                                             "emit.cull_tile": 3,
                                             "blend_plain.cnt": 6})
    assert u["reads"] == sum(u["sites"].values())
    assert u["read_wait_ms"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the preprocess kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_step_takes_the_preprocess_kernels(cuda):
    """A fused step on the card launches the preprocess's forward kernel and
    its backward kernel once a render, inside ``raster.preprocess`` and
    ``raster.preprocess.bwd``, and waits for the card 16 times: the plain
    preprocess's ``projection.px`` and ``raster.px_scale`` reads are gone."""
    scene = scene_from_arrays(make_scene_arrays(
        n_views=3, width=32, height=32, hf_res=64, n_buildings=2, seed=0,
        scale=12.0), device=cuda)
    cfg = tconfig.baseogs(iterations=50)
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    tr = tt.Trainer(cfg, scene, RasterizeConfig(binning_mode="fused",
                                                tile_cull=True),
                    device=cuda).setup()
    tr.train_step(1)  # builds the kernels
    tracer.enable()
    for it in (2, 3):
        tr.train_step(it)
    u = tracer.per_unit("train.step")
    assert u["units"] == 2
    for name in ("raster.preprocess", "raster.preprocess.bwd"):
        assert u["spans"][name]["count"] == RENDERS_A_STEP, name
    assert u["counts"] == {"raster.preprocess.cuda": RENDERS_A_STEP}
    assert u["sites"] == CARD_SITES
    assert u["reads"] == 16


def test_dual_step_opens_one_span_a_modality():
    """The dual MS step (mode fixed): ``train.forward.msi`` and
    ``train.forward.pan`` once a step each, under ``train.forward``, each
    holding its camera's three renders."""
    scene = scene_from_arrays(make_scene_arrays(
        n_views=3, width=32, height=32, hf_res=64, n_buildings=2, seed=0,
        scale=12.0, modality="ms"), device="cpu")
    cfg = tconfig.eogsplus(iterations=50)
    tconfig._apply_mode(cfg, "fixed")
    cfg.model.repeat_gt = False
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    tr = tt.Trainer(cfg, scene, RasterizeConfig(binning_mode="fused",
                                                tile_cull=True),
                    device="cpu").setup()
    assert [m[0] for m in tr.modal_views] == ["msi", "pan"]
    tracer.enable()
    for it in (1, 2):
        tr.train_step(it)
    spans = tracer.spans()
    by_id = {s["id"]: s for s in spans}
    u = tracer.per_unit("train.step")
    assert u["units"] == 2
    for name in ("train.forward.msi", "train.forward.pan"):
        assert u["spans"][name]["count"] == 1, name
        mine = [s for s in spans if s["name"] == name]
        assert all(by_id[s["parent"]]["name"] == "train.forward"
                   for s in mine)
        ids = {s["id"] for s in mine}
        assert sum(s["parent"] in ids for s in spans
                   if s["name"] == "raster.emission") == 2 * RENDERS_A_STEP
    assert u["spans"]["raster.emission"]["count"] == 2 * RENDERS_A_STEP


def test_a2a_exchange_span_once_per_exchange(tmp_path):
    """On the a2a path (2 gloo ranks) ``a2a.exchange`` wraps each
    all_to_all of the pair windows: one in the forward, one in the
    backward (on autograd's thread, under ``train.backward``). The render's
    front half is the one-card ``raster.preprocess``, once."""
    from tests import torch_parallel_worker as W

    rs = W.run(W.a2a_exchange_spans, 2, tmp_path, 64, 64)
    for r in rs:
        assert r["names"].count("a2a.exchange") == 2
        assert r["names"].count("raster.preprocess") == 1
        assert sorted(r["exchange_parents"]) == ["train.backward",
                                                 "train.forward"]


def test_host_read_returns_the_plain_read_and_counts_every_read():
    """Off and on, host_read returns what the plain read returns; on, it
    counts every read, also from more threads than cores at once."""
    import sys
    import threading

    x = torch.arange(6).reshape(2, 3)
    for on in (False, True):
        tracer.enable(on)
        assert host_read(x.sum(), "t.sum") == int(x.sum())
        assert host_read(x, "t.list") == x.tolist()
        got = host_read(lambda: x[x > 2], "t.mask")
        assert torch.equal(got, x[x > 2])
    s = tracer.summary()["reads"][""]
    assert {k: v["count"] for k, v in s.items()} == {
        "t.sum": 1, "t.list": 1, "t.mask": 1}

    def reads():
        for _ in range(200):
            host_read(x[0, 0], "t.many", syncs=2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reads) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracer.summary()["reads"][""]["t.many"]["count"] == 16 * 200 * 2


def test_serving_request_spans(trainer):
    tracer.enable()
    cam = trainer.scene.train_views[0].camera
    for _ in range(2):
        out = render_view_full(trainer.model, cam, trainer.raster_cfg,
                               shading=trainer.shading, view_idx=0)
    assert set(out) >= {"final", "altitude", "rendered_uva"}
    u = tracer.per_unit("serve.request")
    assert u["units"] == 2
    assert u["spans"]["raster.emission"]["count"] == 2  # main and sun
    assert u["spans"]["serve.shading"]["count"] == 1
    assert u["spans"]["serve.to_host"]["count"] == 1
    assert u["sites"]["serve.to_host"] == 8  # the eight outputs
    ids = [s["unit_id"] for s in tracer.spans()
           if s["name"] == "serve.request"]
    assert ids == [1, 2]


def test_profiler_turns_the_tracer_on_and_off(trainer):
    assert not tracer.recording()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tracer.recording()
        step(trainer)
    assert not tracer.recording()
    assert tracer.per_unit("train.step")["units"] == 1
    ev = {}
    for e in prof.events():
        ev.setdefault(e.name, []).append(e.time_range)
    [unit] = ev["train.step"]
    for name in ("train.forward", "train.backward", "raster.emission",
                 "raster.blend_bwd", "resample.bwd"):
        assert name in ev, name
        for r in ev[name]:  # on the profiler's clock, inside the step
            assert unit.start <= r.start <= r.end <= unit.end, name
    assert len(ev["raster.emission"]) == RENDERS_A_STEP


def test_dump_writes_json_that_reads_back(tmp_path):
    tracer.enable()
    with span("serve.request", unit=True):
        with span("serve.to_host"):
            host_read(torch.ones(2), "serve.to_host")
    path = tmp_path / "out" / "spans.json"
    tracer.dump(str(path))
    with open(path) as f:
        d = json.load(f)
    assert [s["name"] for s in d["spans"]] == ["serve.to_host",
                                               "serve.request"]
    assert d["summary"]["units"] == {"serve.request": 1}
    assert d["summary"]["reads"]["serve.request"]["serve.to_host"][
        "count"] == 1
    assert d["spans"][0]["parent"] == d["spans"][1]["id"]


def test_buffer_is_bounded():
    tr = Tracer(capacity=3)
    tr.enable()
    for i in range(5):
        with tr.span("s"):
            pass
    assert len(tr.spans()) == 3 and tr.dropped == 2
    assert tr.summary()["dropped"] == 2
    tr.reset()
    assert tr.summary() == dict(units={}, spans={}, reads={}, dropped=0)


def test_decorated_function_records_per_call():
    tr = Tracer()

    @tr.span("work")
    def work(x):
        """Doubles."""
        return 2 * x

    assert work(2) == 4 and work.__doc__ == "Doubles."
    assert tr.summary()["spans"] == {}
    tr.enable()
    work(3)
    assert tr.summary()["spans"][""]["work"]["count"] == 1
