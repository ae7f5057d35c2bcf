"""``idle_share.rollout.refresh1`` (%): ``idle_share.rollout`` in the cells that report
``rollout_particle_steps_per_s.refresh1`` (rollouts that rebuild the graph
every step), read by ``idle_share.rollout``'s reader."""

from benchmark.harness.manifest import reader

read = reader("idle_share.rollout").read
