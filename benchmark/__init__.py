"""The benchmark of eogs2_tpu_torch on NVIDIA H100 cards (BENCHMARK.json).

Its harness, traffic, reference and yardstick: ``run.py`` runs one cell.
It imports the program it measures and nothing of the JAX package.
"""
