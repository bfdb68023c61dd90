"""Plain PyTorch reference of the benchmark's cells.

It imports nothing of the program and takes nothing the program made: it
builds its cameras from the scene's metadata, its Gaussians from the scene's
points, and works out again everything the program derives from them (the
kNN scales, the pair lists, the losses, the gradients, Adam's update).

``precision`` is ``"fp32"`` everywhere, or ``"tf32"`` for the control: the
inputs of every matrix product and convolution rounded to TF32's 10-bit
mantissa, as the card's TF32 path does, on the CPU as on the card.
"""
