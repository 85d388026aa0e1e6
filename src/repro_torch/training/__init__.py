"""The port's training step: AdamW on named tensors and the train-step
factory with microbatch accumulation (counterparts of
``repro.training.optimizer`` and ``repro.training.train_lib``)."""
from .optimizer import (AdamWConfig, adamw_init, adamw_update,  # noqa
                        global_norm)
from .train_lib import TrainConfig, init_train_state, make_train_step  # noqa
