"""nbody_tpu_torch — the PyTorch and CUDA port of ``nbody_tpu``, for NVIDIA
Hopper (H100).

The JAX package ``nbody_tpu`` is the reference; this package keeps its
subpackage layout, public names, argument order and array layouts:

- ``core``    — direct-sum physics engine and integrators
- ``ics``     — galaxy initial-condition generators (``torch.Generator``)
- ``ops``     — the hand-written CUDA kernels (``csrc/``) with their torch
                twins, exact kNN and masked neighbour reductions
- ``models``  — the EdgeConv ``GraphModel`` and a flax-to-torch converter
- ``data``    — trajectory dataset generation and snapshot batching
- ``train``   — graph building, autoregressive rollout, and evaluation
- ``cli``     — ``python -m nbody_tpu_torch.cli.datagen``
- ``utils``   — device timing

It imports ``torch``, ``numpy`` and ``pandas``, never ``jax``.
"""

__version__ = "0.1.0"
