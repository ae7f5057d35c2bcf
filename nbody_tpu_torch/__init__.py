"""nbody_tpu_torch — the PyTorch and CUDA port of ``nbody_tpu``, for NVIDIA
Hopper (H100).

The JAX package ``nbody_tpu`` is the reference; this package keeps its
subpackage layout, public names, argument order and array layouts:

- ``core``    — direct-sum physics engine and integrators
- ``ics``     — galaxy initial-condition generators, drawn from
                ``jax.random``'s keyed streams (``utils.prng``)
- ``ops``     — the hand-written CUDA kernels (``csrc/``) with their torch
                twins, exact and Morton kNN, radius search, trilinear
                interpolation, the ContConv collect and masked reductions
- ``models``  — the EdgeConv ``GraphModel``, the ``ContinuousConvModel``
                and a flax-to-torch converter
- ``data``    — trajectory dataset generation and snapshot batching
- ``train``   — graph building, autoregressive rollout, and evaluation
- ``experiments`` — ``python -m nbody_tpu_torch.experiments.large_scale``
- ``cli``     — ``python -m nbody_tpu_torch.cli.datagen``
- ``utils``   — device timing and ``prng``, ``jax.random``'s threefry streams

It imports ``torch``, ``numpy`` and ``pandas``, never ``jax``.
"""

__version__ = "0.1.0"
