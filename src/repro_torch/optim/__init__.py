"""Optimizers (port of ``repro.optim``)."""
from .adamw import AdamWConfig, OptState, global_norm, init, schedule, update

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "schedule",
           "update"]
