"""chip_smoke.py's four-card phase (phase_multicard) rehearsed on the CPU:
its rank function, multicard_rank, in a gloo group of 4 ranks started by
tests/torch_parallel_worker.run (the ranks import no JAX), on a 64^2
synthetic scene with 2 + 2 a2a steps and a 1 m TSDF; and the --multicard
switch's refusal with fewer than 4 cards.

The rank function raises at each gate; on the CPU the kernel wrappers take
their plain versions (so the bands' K1/K2/K3 against the plain versions
agree exactly) and the launch gates count the plain versions' calls. The
tests read what the gates held:

  (a) the a2a main render against rasterize on one device: image atol
      5e-5, each input's gradient within 2e-4 of its largest value, no
      pair dropped, each rank's K1/K2 at its band's tile0;
  (b) the a2a Trainer: step 1 repeated from one state bit for bit, the
      row payload's step 1 with the column step's loss bits, the one
      device Trainer's losses (step 1 within rel 1e-6), the windows;
  (c) a gspmd step against one device's (loss rel 1e-6, gradients 2e-4 of
      the largest), views_per_step=2 over a ("d", "g") = 2 x 2 mesh
      (losses rel 1e-6);
  (d) the sharded TSDF equal to the unsharded one bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests import torch_parallel_worker as W

RANKS = 4
OPTS = dict(warmup=2, timed=2, tsdf_vox=1.0,
            small_scene=dict(n_views=4, width=64, height=64, hf_res=128,
                             n_buildings=4, seed=3, scale=12.0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """multicard_rank's reports from 4 gloo ranks (every gate passed)."""
    from eogs2_tpu_torch.data.synthetic import make_scene_arrays

    tmp = tmp_path_factory.mktemp("multicard")
    path = str(tmp / "scene.npz")
    cs.save_scene_arrays(make_scene_arrays(**W.SCENE_KW), path)
    return W.run(cs.multicard_rank, RANKS, tmp / "ranks", path, OPTS)


def test_scene_arrays_round_trip(tmp_path):
    from eogs2_tpu_torch.data.synthetic import make_scene_arrays

    arrays = make_scene_arrays(**W.SCENE_KW)
    path = str(tmp_path / "scene.npz")
    cs.save_scene_arrays(arrays, path)
    back = cs.load_scene_arrays(path)
    assert back.metadatas == arrays.metadatas
    assert (back.train_names, back.test_names) == (arrays.train_names,
                                                   arrays.test_names)
    assert sorted(back.images) == sorted(arrays.images)
    for k, v in arrays.images.items():
        np.testing.assert_array_equal(back.images[k], v)
    np.testing.assert_array_equal(back.heightfield, arrays.heightfield)


def test_a2a_render_against_one_device(ranks):
    render = ranks[0]["render_a2a_vs_fused"]
    assert render["image_max_abs_err"] <= 5e-5
    assert max(render["grad_max_rel_err"].values()) <= 2e-4
    assert render["dropped_pairs"] == 0
    tile0s = [r["band"]["tile0"] for r in ranks]
    assert tile0s[0] == 0 and all(t > 0 for t in tile0s[1:])
    assert tile0s == sorted(tile0s)
    for r in ranks:
        assert all(a == b == r["band"]["tile0"] for a, b in r["tile0s"])
        assert r["band"]["k1_n_contrib_mismatches"] == 0
        assert r["band"]["k3_fwd_bitwise_equal_k1"]
        assert r["band"]["k3_bwd_bitwise_equal_k2"]


def test_a2a_trainer_against_one_device(ranks):
    timed = OPTS["timed"]
    for r in ranks:
        assert r["step1_repeat_bitwise_equal"]
        assert r["k3_loss_bitwise_equal"]
        assert tuple(r["k3_step_launches"]) == (3, 3)
        assert r["a2a"]["k1_launches"] == r["a2a"]["k2_launches"] == 3 * timed
        assert r["a2a"]["dropped_pairs"] == 0
        assert r["a2a"]["losses"] == ranks[0]["a2a"]["losses"]
    one = ranks[0]["one_card_fused"]
    assert len(one["losses"]) == OPTS["warmup"] + timed
    assert one["loss_rel_diff"][0] <= 1e-6
    a2a = ranks[0]["a2a"]
    for name in cs.TRAIN_RENDERS:
        w = np.asarray(a2a["windows"][name]["per_source_and_band"])
        assert w.shape == (RANKS, RANKS)
        assert w.max() == a2a["windows"][name]["max"] <= a2a["dest_cap"]
    assert a2a["max_dest_count"] <= a2a["dest_cap"]


def test_gspmd_and_views_split_against_one_device(ranks):
    g = ranks[0]["gspmd"]
    assert g["loss_rel_diff"] <= 1e-6
    assert max(g["grad_max_rel_err"].values()) <= 2e-4
    assert g["views_per_step_2_mesh"] == {"d": 2, "g": 2}
    assert max(g["views_per_step_2_loss_rel_diff"]) <= 1e-6
    assert all(r["gspmd"] is None for r in ranks[1:])


def test_sharded_tsdf_equals_unsharded(ranks):
    t = ranks[0]["tsdf_south_sharded"]
    assert t["sharded_bitwise_equal"] and t["maps_equal_on_ranks"]
    assert t["weighted_share"] > 0.1


def test_multicard_switch_refuses_fewer_cards(monkeypatch):
    """--multicard with fewer than 4 visible cards raises before any work
    (no nvidia-smi, no build), so the run exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_work(*args, **kw):
        raise AssertionError("work started")

    monkeypatch.setattr(cs, "card_line", no_work)
    monkeypatch.setattr(cs, "phase_build", no_work)
    with pytest.raises(RuntimeError, match="needs 4 cards; 1 visible"):
        cs.main(["--multicard"])
