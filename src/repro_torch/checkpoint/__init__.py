from . import checkpoint
from .checkpoint import (
    CheckpointCorruptError,
    available_steps,
    latest_step,
    read_manifest,
    restore,
    restore_tree,
    save,
)

__all__ = ["checkpoint", "save", "restore", "restore_tree", "read_manifest",
           "latest_step", "available_steps", "CheckpointCorruptError"]
