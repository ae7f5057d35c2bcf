"""``morton_select_roofline.refresh1`` (%): ``morton_select_roofline`` in the cells that report
``rollout_particle_steps_per_s.refresh1`` (rollouts that rebuild the graph
every step), read by ``morton_select_roofline``'s reader."""

from benchmark.harness.manifest import reader

read = reader("morton_select_roofline").read
