"""Checkpoints of the port — the counterpart of ``repro.checkpoint``."""
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore_checkpoint,
                                            save_checkpoint)
