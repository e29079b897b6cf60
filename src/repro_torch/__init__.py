"""PyTorch/CUDA port of the ``repro`` package (TP-Aware Dequantization).

The subpackages mirror ``repro``'s layout; each module names the JAX
module it answers to.  The port imports ``torch`` and numpy only: never
``jax``, and nothing from ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; see ``repro_torch.device.resolve_device``.
"""
