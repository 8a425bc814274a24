"""Atomic, manifest-verified checkpoints, counterpart of ``repro/checkpoint``."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
