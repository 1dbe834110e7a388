from .optimizer import AdamWConfig, adamw_init, adamw_update, schedule, global_norm
from .step import TrainConfig, init_train_state, loss_and_grads, make_train_step
