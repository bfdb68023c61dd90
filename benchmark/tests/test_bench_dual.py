"""The two kinds added beside ``train`` and ``render``, through the
unchanged harness on the CPU at the tiny size: the dual-modality cell
(kind ``train_dual``; PAN 64^2, MSI 16^2) and the four-card a2a cell (kind
``a2a``, four gloo ranks). The dual cell's limits fail the control and
each fault, planted in the reference or in the program."""

import json
import os
import shutil

import pytest
import torch

from tiny import ROOT, make_root, run_cell

DUAL = "eogsplus-fixed-1M-1024"


def dual_root(tmp):
    """The tiny root of the dual configuration: the MSI at a quarter of the
    tiny PAN width, as the configuration has it."""
    root = make_root(tmp, DUAL)
    path = os.path.join(root, "benchmark", "configs", "tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs", f"{DUAL}.json")) as f:
        cfg["scene"]["msi_factor"] = json.load(f)["scene"]["msi_factor"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def test_dual_cell_runs(tmp_path, capsys):
    root = dual_root(str(tmp_path))
    rc, res, err = run_cell(root, "tiny.train-dual", capsys, trace=0)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"setup_s", "step_ms"}
    rc, res, err = run_cell(root, "tiny.train-dual", capsys, trace=1)
    assert rc == 0 and res["correct"], err
    m = res["metrics"]
    # the train cells' readers too; no kernel ran on the CPU, so K1's and
    # K2's shares read nothing
    assert set(m) == {"msi_ms.dual", "pan_ms.dual", "pairs_msi.dual",
                      "mfu.train", "pairs.train", "idle.train",
                      "emission_ms.train", "resample_ms.train",
                      "host_reads.train", "read_wait_ms.train"}
    assert 0 < m["pairs_msi.dual"]["value"] < m["pairs.train"]["value"]
    assert m["mfu.train"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_control_and_faults_fail_the_dual_limits(tmp_path, seed):
    from benchmark import check
    from benchmark.common import load_kind
    from benchmark.run import load_cell

    root = dual_root(str(tmp_path))
    _, cfg, traffic, _, _ = load_cell(root, "tiny.train-dual")
    r = load_kind(root, "train_dual").readings(cfg, traffic, seed,
                                               torch.device("cpu"))
    lims = check.limits(ROOT, f"{DUAL}.train-dual")
    assert check.judge(r["program"], lims)[0], r["program"]
    for bad in ("control", "half_batch", "pan_average"):
        assert not check.judge(r[bad], lims)[0], (bad, r[bad])


def test_pan_average_in_the_program_fails_the_check(tmp_path, capsys,
                                                    monkeypatch):
    """The program's PAN camera converted by the mean of its colours: the
    harness's run is not correct."""
    from eogs2_tpu_torch import shading

    real = shading.msi_to_pan

    def average(img, mode, weight=None, bias=None):
        return real(img, "average" if mode == "fixed" else mode, weight,
                    bias)

    monkeypatch.setattr(shading, "msi_to_pan", average)
    root = dual_root(str(tmp_path))
    rc, res, err = run_cell(root, "tiny.train-dual", capsys, trace=0)
    assert rc == 0 and not res["correct"], err


def test_a2a_cell_runs_on_four_ranks(tmp_path, capsys):
    """The four-card cell's kind, mix, limits and readers, which
    BENCHMARK.json does not list (its runs spread too widely on the chip),
    entered in a tiny root as a cell would be."""
    root = make_root(str(tmp_path))
    cell = "tiny.train-a2a-4card"
    shutil.copy(os.path.join(ROOT, "benchmark", "limits",
                             "baseogs-1M-1024.train-a2a-4card.json"),
                os.path.join(root, "benchmark", "limits", f"{cell}.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": cell, "config": "tiny",
                           "traffic": "train-a2a", "chips": 4,
                           "why": "the a2a Trainer at four gloo ranks"})
    for m in b["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append(cell)
    b["per_layer"] += [{"name": n, "unit": "ms", "better": "lower",
                        "source": "program_span", "layer": "multi-device",
                        "moves": "step_ms", "workloads": [cell]}
                       for n in ("exchange_ms.a2a", "rank_skew_ms.a2a")]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    rc, res, err = run_cell(root, cell, capsys, trace=1, seconds=1.0)
    assert rc == 0 and res["correct"], err
    assert res["device"]["count"] == 4
    assert set(res["metrics"]) == {"exchange_ms.a2a", "rank_skew_ms.a2a"}
    assert res["metrics"]["exchange_ms.a2a"]["value"] > 0
    assert "cores by rank" in err
