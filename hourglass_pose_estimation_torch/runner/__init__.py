"""Runner of the port: the train and eval steps, checkpoints, the Trainer,
the standalone Evaluator and the Estimator."""

from hourglass_pose_estimation_torch.runner.train_state import (
    RMSpropSchedule, TrainState, init_state, make_eval_step, make_optimizer,
    make_train_step)
from hourglass_pose_estimation_torch.runner import checkpoint
from hourglass_pose_estimation_torch.runner.trainer import Trainer
from hourglass_pose_estimation_torch.runner.evaluator import Evaluator, flip_heatmaps
from hourglass_pose_estimation_torch.runner.estimator import Estimator
