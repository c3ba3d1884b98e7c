"""Drivers, run as ``python -m dmip_tpu_torch.mains.<name>``."""
