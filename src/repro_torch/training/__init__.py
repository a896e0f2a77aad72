"""Loss, AdamW and the train step: the port's copy of ``repro.training``."""
from repro_torch.training.loss import cross_entropy, loss_fn
from repro_torch.training.optimizer import (OptHParams, adamw_update,
                                            init_opt_state)
from repro_torch.training.step import (init_train_state, make_train_step,
                                       train_step)
