"""Training: the single-device, data-parallel and captured train steps."""

from repro_torch.training.train_step import (  # noqa: F401
    TrainStepConfig, init_state, make_loss_fn,
    make_captured_dp_train_step, make_dp_train_step, make_train_step,
    replicate_state, state_shapes, state_shardings)
