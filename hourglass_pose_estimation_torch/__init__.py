"""PyTorch / CUDA port of `hourglass_pose_estimation_tpu` for NVIDIA
Hopper (H100). Imports torch, never JAX; the JAX package is the reference
its tests hold it against."""
