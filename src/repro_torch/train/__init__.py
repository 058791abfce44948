"""Training substrate: the token data pipeline, the NN trainer's loop
and pytree checkpoints, and the session checkpoint format."""

from repro_torch.train.checkpoint import (
    CheckpointCorruptError,
    SessionCheckpoint,
    SpecMismatchError,
    discard_session_checkpoint,
    load_model_weights,
    load_session_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    save_session_checkpoint,
)
from repro_torch.train.data import MarkovTextStream, TokenMicroBatch, bigram_entropy_floor
from repro_torch.train.loop import TrainReport, train

__all__ = [
    "CheckpointCorruptError",
    "MarkovTextStream",
    "SessionCheckpoint",
    "SpecMismatchError",
    "TokenMicroBatch",
    "TrainReport",
    "bigram_entropy_floor",
    "discard_session_checkpoint",
    "load_model_weights",
    "load_session_checkpoint",
    "restore_checkpoint",
    "save_checkpoint",
    "save_session_checkpoint",
    "train",
]
