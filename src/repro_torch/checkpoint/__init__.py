from repro_torch.checkpoint.ckpt import (checkpoint_steps, flatten_tree,
                                         latest_step, restore_checkpoint,
                                         restore_state, save_checkpoint,
                                         save_state, unflatten_like)

__all__ = ["checkpoint_steps", "flatten_tree", "latest_step",
           "restore_checkpoint", "restore_state", "save_checkpoint",
           "save_state", "unflatten_like"]
