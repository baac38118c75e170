"""Training runner of the port: the train and eval steps, checkpoints and
the Trainer."""

from hourglass_pose_estimation_torch.runner.train_state import (
    RMSpropSchedule, TrainState, init_state, make_eval_step, make_optimizer,
    make_train_step)
from hourglass_pose_estimation_torch.runner import checkpoint
from hourglass_pose_estimation_torch.runner.trainer import Trainer
