"""repro_torch.training — AdamW and the training step."""
from .optimizer import (AdamWConfig, AdamWState, adamw_init,
                        adamw_state_pspecs, adamw_update, adamw_update_,
                        global_norm, lr_schedule)
from .trainer import (TrainState, gather_train_state, init_train_state,
                      make_grad_and_apply, make_train_step, param_tree,
                      shard_train_state, state_bytes, train_state_pspecs)

__all__ = ["AdamWConfig", "AdamWState", "TrainState", "adamw_init",
           "adamw_state_pspecs", "adamw_update", "adamw_update_",
           "gather_train_state", "global_norm", "init_train_state",
           "lr_schedule", "make_grad_and_apply", "make_train_step",
           "param_tree", "shard_train_state", "state_bytes",
           "train_state_pspecs"]
