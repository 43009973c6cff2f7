from .optim import (AdamWState, adamw_init, adamw_update, global_norm,
                    lr_schedule)
from .step import make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "lr_schedule", "make_train_step"]
