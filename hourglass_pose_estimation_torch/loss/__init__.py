"""Training loss of the port."""

from hourglass_pose_estimation_torch.loss.mse import heatmap_mse_loss
