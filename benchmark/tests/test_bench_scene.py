"""The device scene generator against the program's host one."""

import numpy as np
import pytest
import torch

from benchmark.scene import init_cloud, make_scene


@pytest.mark.parametrize("seed", [5, 3000000001])
def test_scene_equals_make_scene_arrays(seed):
    from eogs2_tpu_torch.data.synthetic import make_scene_arrays

    size = dict(n_views=4, width=64, height=48, hf_res=128, n_buildings=4,
                scale=12.0)
    s = make_scene(size, seed, torch.device("cpu"))
    a = make_scene_arrays(n_views=4, width=64, height=48, hf_res=128,
                          n_buildings=4, seed=seed % 2**32, scale=12.0)
    assert s.metadatas == a.metadatas
    assert (s.train_names, s.test_names) == (a.train_names, a.test_names)
    assert np.array_equal(s.heightfield, a.heightfield)
    for name, img in a.images.items():
        np.testing.assert_allclose(s.images[name].numpy(),
                                   img.transpose(2, 0, 1), atol=1e-6)


def test_init_cloud_density_and_box():
    mn, mx = [-0.85, -0.85, -0.35], [0.85, 0.85, 0.35]
    xyz, rgb = init_cloud(mn, mx, 12.0, 0.13, 7, torch.device("cpu"))
    n_draw = int(0.13 * 8 * 12.0 ** 3)
    keep = 0.935 * 0.935 * 0.385
    assert abs(xyz.shape[0] / n_draw - keep) < 0.05
    assert (xyz.abs() <= torch.tensor([0.935, 0.935, 0.385])).all()
    assert (rgb == 1.1).all()
    again, _ = init_cloud(mn, mx, 12.0, 0.13, 7, torch.device("cpu"))
    assert torch.equal(xyz, again)
