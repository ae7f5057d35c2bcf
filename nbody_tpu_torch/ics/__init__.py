from nbody_tpu_torch.ics.profiles import spherical_hernquist_distribution
from nbody_tpu_torch.ics.disk import generate_disk
from nbody_tpu_torch.ics.spiral import generate_spiral
from nbody_tpu_torch.ics.compose import compose

GENERATORS = {"disk": generate_disk, "spiral": generate_spiral}

__all__ = [
    "spherical_hernquist_distribution",
    "generate_disk",
    "generate_spiral",
    "compose",
    "GENERATORS",
]
