"""Training runner of the port (this slice: the train and eval steps)."""

from hourglass_pose_estimation_torch.runner.train_state import (
    RMSpropSchedule, TrainState, init_state, make_eval_step, make_optimizer,
    make_train_step)
