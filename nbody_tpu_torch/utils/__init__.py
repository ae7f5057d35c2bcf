from nbody_tpu_torch.utils.timing import cuda_time_ms, device_time, synchronize

__all__ = ["cuda_time_ms", "device_time", "synchronize"]
