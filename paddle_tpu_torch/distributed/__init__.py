"""Training on one device (port of ``paddle_tpu/distributed/``'s trainer;
the mesh, collectives and fleet come with distributed training)."""
from .trainer import TrainState, Trainer  # noqa: F401

__all__ = ["TrainState", "Trainer"]
