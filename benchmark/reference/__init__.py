"""Plain-PyTorch reference of the benchmark's cells: the neighbour searches,
both surrogates' forward passes, the training loss, Adam and the leapfrog
step, written from the published models. It imports nothing of
``nbody_tpu_torch``, ``nbody_tpu``, ``jax`` or ``flax``, and takes nothing
the program made: it works out graphs, batch orders and updates again from
the benchmark's own inputs and weights."""
