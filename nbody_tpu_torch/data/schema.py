"""The long-format trajectory CSV schema — the port of
``nbody_tpu/data/schema.py`` (reference ``src/s01-dataset-generation.py:108-125``).
The same columns in the same order, so datasets written by the JAX package,
the port and the reference interoperate."""

CSV_FIELDS = [
    "scene",
    "scene_type",
    "step",
    "step_time",
    "mass",
    "x",
    "y",
    "z",
    "vx",
    "vy",
    "vz",
    "ax",
    "ay",
    "az",
    "u",
    "k",
]
