"""A copy of the benchmark's data at a size the CPU holds: the cells of
BENCHMARK.json on the tiny configuration, in a temporary root that the
harness reads as it reads the checkout."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCENE = dict(n_views=4, width=64, height=64, hf_res=128, n_buildings=4,
             scale=12.0, density=0.13)


def make_root(tmp, config="baseogs-1M-1024"):
    """A root with BENCHMARK.json's cells renamed onto ``tiny``, the
    configuration at SCENE, the kinds, traffic, metrics and limits copied,
    and the train window's checked step moved to the steps a short window
    reaches."""
    bench = os.path.join(tmp, "benchmark")
    for sub in ("kinds", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub),
                        os.path.join(bench, sub))
    mix = os.path.join(bench, "traffic", "train.json")
    with open(mix) as f:
        train = json.load(f)
    train["window_check"] = dict(train["window_check"], after=5, span=3)
    with open(mix, "w") as f:
        json.dump(train, f)
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{config}.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", scene=dict(SCENE, seed=cfg["scene"]["seed"],
                                       modality=cfg["scene"].get(
                                           "modality", "msi")))
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [dict(c, name="tiny", file="benchmark/configs/tiny.json")
                    for c in b["configs"] if c["name"] == config]
    b["workloads"] = [dict(w, config="tiny",
                           name=w["name"].replace(config, "tiny"))
                      for w in b["workloads"] if w["config"] == config]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [x.replace(config, "tiny")
                              for x in m["workloads"]]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    for w in b["workloads"]:
        shutil.copy(os.path.join(bench, "limits",
                                 w["name"].replace("tiny", config) + ".json"),
                    os.path.join(bench, "limits", w["name"] + ".json"))
    return tmp


def run_cell(root, workload, capsys, seed=3000000001, trace=0,
             seconds=0.3):
    """Run a cell on the CPU; (exit code, result line, standard error)."""
    from benchmark import run

    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  root=root, device="cpu")
    out, err = capsys.readouterr()
    line = out.strip().splitlines()[-1] if out.strip() else ""
    return rc, (json.loads(line) if line.startswith("{") else None), err
