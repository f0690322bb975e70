"""repro_torch.ckpt: checkpoints in the JAX package's format (``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (SEP, CheckpointManager,
                                         CheckpointWriteError,
                                         available_steps, load_checkpoint,
                                         save_checkpoint)

__all__ = ["SEP", "CheckpointManager", "CheckpointWriteError",
           "available_steps", "save_checkpoint", "load_checkpoint"]
