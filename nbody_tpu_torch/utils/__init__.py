from nbody_tpu_torch.utils.debug import assert_finite_state, checked_accelerations
from nbody_tpu_torch.utils.timing import cuda_time_ms, device_time, synchronize

__all__ = ["cuda_time_ms", "device_time", "synchronize", "checked_accelerations",
           "assert_finite_state"]
