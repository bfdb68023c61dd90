"""The check fails what it must: the control (the reference in TF32 in
the program's place) and each fault a cell can have, planted under a run
of the harness on the CPU at the tiny size, against the committed
limits. A cuda case reads the control at the cell's own size."""

import json
import os

import pytest
import torch

from tiny import ROOT, make_root, run_cell


def tiny_readings(root, kind, seed):
    from benchmark.common import load_kind
    from benchmark.run import load_cell

    _, cfg, traffic, _, _ = load_cell(root, f"tiny.{kind}")
    return load_kind(root, kind).readings(cfg, traffic, seed,
                                          torch.device("cpu"))


@pytest.mark.parametrize("config", ["baseogs-1M-1024", "eogsplus-1M-1024"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_train_limits(tmp_path, seed, config):
    from benchmark import check

    r = tiny_readings(make_root(str(tmp_path), config), "train", seed)
    lims = check.limits(ROOT, f"{config}.train")
    assert check.judge(r["program"], lims)[0]
    for bad in ("control", "half_batch", "altered"):
        assert not check.judge(r[bad], lims)[0], (bad, r[bad])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_render_limits(tmp_path, seed):
    from benchmark import check

    r = tiny_readings(make_root(str(tmp_path)), "render", seed)
    lims = check.limits(ROOT, "baseogs-1M-1024.render")
    assert check.judge(r["program"], lims)[0]
    for bad in ("control", "altered"):
        assert not check.judge(r[bad], lims)[0], (bad, r[bad])


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from eogs2_tpu_torch import losses

    real = losses.photometric_loss

    def half(pred, gt, lambda_dssim=0.2, mask=None):
        h = pred.shape[-2] // 2
        return real(pred[..., :h, :], gt[..., :h, :], lambda_dssim,
                    None if mask is None else mask[..., :h, :])

    monkeypatch.setattr(losses, "photometric_loss", half)


def _altered(module):
    def plant(monkeypatch):
        import importlib

        mod = importlib.import_module(module)
        real = mod.rasterize

        def altered(*a, **k):
            ro = real(*a, **k)
            img = ro.image.clone()
            img[:3, :16, :16] += 0.25
            return ro._replace(image=img)

        monkeypatch.setattr(mod, "rasterize", altered)
    return plant


@pytest.mark.parametrize("config,cell,fault", [
    (c, "tiny.train", f) for c in ("baseogs-1M-1024", "eogsplus-1M-1024")
    for f in (_unchanged, _half_batch, _altered("eogs2_tpu_torch.train"))
] + [("baseogs-1M-1024", "tiny.render",
      _altered("eogs2_tpu_torch.pipeline"))])
def test_planted_fault_is_not_correct(tmp_path, capsys, monkeypatch, config,
                                      cell, fault):
    root = make_root(str(tmp_path), config)
    fault(monkeypatch)
    rc, res, err = run_cell(root, cell, capsys)
    assert rc == 0 and res is not None
    assert res["correct"] is False, err


@pytest.mark.cuda
def test_control_at_the_cell_size(card, capsys):
    """One seed of benchmark/control.py at the train cell's own size."""
    from benchmark import control

    assert control.main(["--workload", "baseogs-1M-1024.train",
                         "--seeds", "5"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from benchmark import check

    lims = check.limits(ROOT, "baseogs-1M-1024.train")
    assert check.judge(row["program"], lims)[0]
    assert not check.judge(row["control"], lims)[0]
