"""The multi-device path: the process group and device mesh, the sharded
Gaussian state, and the all_to_all pair-exchange rasterizer.

Counterpart of ``eogs2_tpu/parallel/``: ``distributed.py`` (process group,
collectives with the gradients a replicated loss needs), ``mesh.py`` (the
("g",) or ("d", "g") ``DeviceMesh`` and the Gaussian shard of the model),
``sharded_raster.py`` (``sharded_rasterize``, ``rasterize_a2a``,
``sharded_render``)."""
