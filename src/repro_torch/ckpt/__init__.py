from .store import (CheckpointStore, restore_tree, save_tree)

__all__ = ["CheckpointStore", "save_tree", "restore_tree"]
