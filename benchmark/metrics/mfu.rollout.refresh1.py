"""``mfu.rollout.refresh1`` (%): ``mfu.rollout`` in the cells that report
``rollout_particle_steps_per_s.refresh1`` (rollouts that rebuild the graph
every step), read by ``mfu.rollout``'s reader."""

from benchmark.harness.manifest import reader

read = reader("mfu.rollout").read
