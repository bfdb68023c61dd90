"""Alpha-compositing constants shared by every blend (forward.cu skip rules).

The jnp-style dense blend of ``eogs2_tpu/ops/blend.py`` arrives with the
gather/sorted raster modes; the fused route composites in the K1 kernel
(ops/fused_raster.py).
"""

ALPHA_EPS = 1.0 / 255.0  # a pair with alpha below this is skipped
ALPHA_MAX = 0.99  # alpha clamp
T_EPS = 1e-4  # a pixel stops once its transmittance would fall below this
