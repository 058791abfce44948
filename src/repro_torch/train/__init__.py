"""Training substrate: the session checkpoint format (the NN trainer's
data pipeline, loop and pytree checkpoints are not in the port yet)."""

from repro_torch.train.checkpoint import (
    CheckpointCorruptError,
    SessionCheckpoint,
    SpecMismatchError,
    discard_session_checkpoint,
    load_model_weights,
    load_session_checkpoint,
    save_session_checkpoint,
)

__all__ = [
    "CheckpointCorruptError",
    "SessionCheckpoint",
    "SpecMismatchError",
    "discard_session_checkpoint",
    "load_model_weights",
    "load_session_checkpoint",
    "save_session_checkpoint",
]
