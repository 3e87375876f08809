from repro_torch.training.optimizer import AdamWConfig, apply_updates, init_opt_state  # noqa: F401
from repro_torch.training.trainer import Trainer, TrainState, make_train_step  # noqa: F401
