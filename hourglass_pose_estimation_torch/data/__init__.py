"""Host data of the port: normalisation statistics, joint counts, the
dataset registry (importing this package registers the synthetic
dataset), the epoch loader, the prefetcher and the device augmentation
pipeline."""

from hourglass_pose_estimation_torch.data.common import (
    REGISTRY, Loader, PoseDataset, PoseRecords, get_dataset, register)
from hourglass_pose_estimation_torch.data.prefetch import Prefetcher
from hourglass_pose_estimation_torch.data.meanstd import (
    ESTIMATOR_MEANSTD, MEANSTD, get_meanstd)
from hourglass_pose_estimation_torch.data.pipeline import (
    PipelineSpec, augment_batch, crop_batch, make_spec, sample_augmentations, to_device)
from hourglass_pose_estimation_torch.data.synthetic import Synthetic

# joints per dataset (the JAX package's dataset classes' n_joints), in the
# order of its registry, which a substring lookup walks
N_JOINTS = {'synthetic': 16, 'mpii': 16, 'mscoco': 17, 'crowdpose': 14,
            'hands': 22}


def resolve_num_classes(cfg) -> int:
    """Explicit MODEL.num_classes, else len(MODEL.subset), else the
    dataset's joint count (as the JAX package resolves it)."""
    mc = cfg.model
    return (mc.num_classes or (len(mc.subset) if mc.subset else 0)
            or N_JOINTS[cfg.dataset.name])
