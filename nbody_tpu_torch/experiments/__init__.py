"""Experiment scripts of the port (``python -m nbody_tpu_torch.experiments.<name>``)."""
