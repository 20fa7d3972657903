from .checkpoint import (CheckpointManager, filter_tree, merge_tree,
                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "filter_tree", "merge_tree",
           "restore_checkpoint", "save_checkpoint"]
