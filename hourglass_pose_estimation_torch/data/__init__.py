"""Host data of the port: normalisation statistics, the dataset registry
(importing this package registers every reader: synthetic, mpii, mscoco,
crowdpose, hands), the epoch loader, the prefetcher, and the device tails
of both input pipelines."""

from hourglass_pose_estimation_torch.data.common import (
    REGISTRY, Loader, PoseDataset, PoseRecords, get_dataset, register)
from hourglass_pose_estimation_torch.data import synthetic as _synthetic  # noqa: F401
from hourglass_pose_estimation_torch.data import mpii as _mpii  # noqa: F401
from hourglass_pose_estimation_torch.data import mscoco as _mscoco  # noqa: F401
from hourglass_pose_estimation_torch.data.prefetch import Prefetcher
from hourglass_pose_estimation_torch.data.meanstd import (
    ESTIMATOR_MEANSTD, MEANSTD, get_meanstd)
from hourglass_pose_estimation_torch.data.mpii import MPII, evaluate_pckh
from hourglass_pose_estimation_torch.data.mscoco import MSCOCO, CrowdPose, Hands
from hourglass_pose_estimation_torch.data.pipeline import (
    PipelineSpec, augment_batch, crop_batch, make_spec, normalize, prepare_host_batch,
    sample_augmentations, to_device)
from hourglass_pose_estimation_torch.data.synthetic import Synthetic

# joints per dataset, in the registry's order (which the Estimator's
# substring lookup walks)
N_JOINTS = {name: cls.n_joints for name, cls in REGISTRY.items()}


def n_joints_for(name: str) -> int:
    if name not in REGISTRY:
        raise KeyError(name)
    return REGISTRY[name].n_joints


def resolve_num_classes(cfg) -> int:
    """Explicit MODEL.num_classes, else len(MODEL.subset), else the
    dataset's joint count (as the JAX package resolves it)."""
    mc = cfg.model
    return (mc.num_classes or (len(mc.subset) if mc.subset else 0)
            or n_joints_for(cfg.dataset.name))
