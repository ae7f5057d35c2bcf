"""The benchmark of ``nbody_tpu_torch``: one command runs one cell once
(``python benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``). See ``benchmark/README.md``."""
