"""The harness finds a cell's configuration, traffic mix, metrics and
limits by name, and takes a new one as new files and entries only."""

import json
import os

from tiny import make_root, run_cell


def test_finds_every_cell_by_name():
    from benchmark import run

    root = run.ROOT
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell, cfg, traffic, per_layer, e2e = run.load_cell(root, w["name"])
        assert cfg["name"] == w["config"] and traffic["kind"]
        assert {m["name"] for m in e2e} >= {"setup_s"}
        assert per_layer
        for m in per_layer:
            assert callable(run.reader(root, m["name"]))
        assert os.path.exists(os.path.join(root, "benchmark", "limits",
                                           w["name"] + ".json"))


def test_new_config_mix_and_metric_are_files_only(tmp_path, capsys):
    """A configuration, a mix and a metric added as files and entries run
    through the unchanged harness."""
    root = make_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny2", scene=dict(cfg["scene"], n_buildings=2))
    with open(os.path.join(bench, "configs", "tiny2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "train.json")) as f:
        mix = json.load(f)
    mix.update(warmup_steps=1, traced_steps=2)
    with open(os.path.join(bench, "traffic", "train_short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "steps.traced.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.run.traced_units)\n")
    with open(os.path.join(bench, "limits", "tiny2.train_short.json"),
              "w") as f:
        json.dump({"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="tiny2",
                             file="benchmark/configs/tiny2.json"))
    b["workloads"].append({"name": "tiny2.train_short", "config": "tiny2",
                           "traffic": "train_short", "chips": 1,
                           "why": "a cell added as data"})
    b["per_layer"].append({"name": "steps.traced", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "train step", "moves": "step_ms",
                           "workloads": ["tiny2.train_short"]})
    for m in b["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("tiny2.train_short")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    rc, res, _ = run_cell(root, "tiny2.train_short", capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["steps.traced"]["value"] == 2.0
    rc, res, _ = run_cell(root, "tiny2.train_short", capsys, trace=0)
    assert rc == 0 and set(res["metrics"]) == {"setup_s", "step_ms"}


SPIN = '''"""A kind added as one file: a loop of one small device op."""
import time

import torch

from benchmark.common import Run, sync
from benchmark.tracing import traced


def run(cell, cfg, traffic, args, device, t0):
    r = Run(setup_s=time.perf_counter() - t0)
    x = torch.ones(traffic["n"], device=device)

    def unit():
        nonlocal x
        x = x * 1.0

    w0 = time.perf_counter()
    while time.perf_counter() - w0 < args.seconds:
        unit()
        r.done += 1
    sync(device)
    r.window_s = time.perf_counter() - w0
    if args.trace:
        with traced(lambda: sync(device)) as r.trace:
            for _ in range(3):
                unit()
        r.traced_units = 3
    r.program_out["sum"] = float(x.sum())
    return r


def check(cfg, traffic, run, seed, device):
    return {"sum_gap": abs(run.program_out["sum"] - traffic["n"])}
'''


def test_new_kind_is_one_file(tmp_path, capsys):
    """A kind of traffic added as one module, with its mix, limits and
    entries, runs through the unchanged harness."""
    root = make_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "kinds", "spin.py"), "w") as f:
        f.write(SPIN)
    with open(os.path.join(bench, "traffic", "spin.json"), "w") as f:
        json.dump({"kind": "spin", "n": 64}, f)
    with open(os.path.join(bench, "limits", "tiny.spin.json"), "w") as f:
        json.dump({"sum_gap": 0.0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": "tiny.spin", "config": "tiny",
                           "traffic": "spin", "chips": 1,
                           "why": "a kind added as one file"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("step_ms", "idle.train"):
            m["workloads"].append("tiny.spin")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    rc, res, err = run_cell(root, "tiny.spin", capsys, trace=0)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"setup_s", "step_ms"}
    assert res["checks"] == {"sum_gap": {"value": 0.0, "limit": 0.0}}
    rc, res, err = run_cell(root, "tiny.spin", capsys, trace=1)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"idle.train"}


def test_no_card_no_result(tmp_path, capsys):
    """Without enough CUDA devices the run exits non-zero and prints no
    result line."""
    import torch

    from benchmark import run

    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "baseogs-1M-1024.train", "--seed", "1",
                   "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and not out.strip()


def test_render_tail_is_per_layer(tmp_path, capsys):
    """The render cell's end-to-end line holds set-up and the mean time a
    view; its traced line holds the 95th percentile of the window."""
    root = make_root(str(tmp_path))
    rc, res, err = run_cell(root, "tiny.render", capsys, trace=0)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"setup_s", "view_ms"}
    rc, res, err = run_cell(root, "tiny.render", capsys, trace=1)
    assert rc == 0 and res["correct"], err
    assert res["metrics"]["view_ms_p95.render"]["value"] > 0
