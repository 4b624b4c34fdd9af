"""repro_torch.training — AdamW and the training step."""
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        global_norm, lr_schedule)
from .trainer import (TrainState, init_train_state, make_grad_and_apply,
                      make_train_step, param_tree)

__all__ = ["AdamWConfig", "AdamWState", "TrainState", "adamw_init",
           "adamw_update", "global_norm", "init_train_state",
           "lr_schedule", "make_grad_and_apply", "make_train_step",
           "param_tree"]
