from .checkpoint import (CheckpointManager, filter_tree, merge_tree,
                         restore_checkpoint, save_checkpoint)
from .registry import instantiate, load_config, lookup, register

__all__ = ["CheckpointManager", "filter_tree", "merge_tree",
           "restore_checkpoint", "save_checkpoint",
           "instantiate", "load_config", "lookup", "register"]
