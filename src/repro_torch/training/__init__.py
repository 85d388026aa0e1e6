"""The port's training step: AdamW on named tensors, the train-step
factory with microbatch accumulation and the int8 gradient compression
(counterparts of ``repro.training.optimizer``, ``repro.training.train_lib``
and ``repro.training.compression``)."""
from .compression import (_quantize, compressed_grad_sync,  # noqa
                          quantized_psum)
from .optimizer import (AdamWConfig, adamw_init, adamw_update,  # noqa
                        global_norm)
from .train_lib import (TrainConfig, init_train_state,  # noqa
                        make_train_step, train_state_specs)
