"""Per-dataset channel normalization statistics (BGR order); the port's
own copy of `hourglass_pose_estimation_tpu/data/meanstd.py`.

Values extracted from the reference's cached statistics
(the reference's `data/<name>/mean.pth.tar`; computed by its
`_compute_mean`, common.py:66-91, over cv2-BGR images scaled to [0,1]).
The whole framework keeps the reference's BGR channel order so that
normalization stats and any ported checkpoints line up.

Note: the reference's `Estimator.preprocess_bbox` hard-codes *different*
mpii numbers (estimator.py:44) than its own mean file — an internal
inconsistency. We use the mean-file values everywhere and keep the
estimator's variant apart (`ESTIMATOR_MEANSTD`) for strict inference parity.
"""

MEANSTD = {
    'coco': ((0.400330, 0.431436, 0.453392), (0.246605, 0.246729, 0.256153)),
    'mscoco': ((0.400330, 0.431436, 0.453392), (0.246605, 0.246729, 0.256153)),
    'crowdpose': ((0.392138, 0.425901, 0.455138), (0.250993, 0.252929, 0.262827)),
    'hands': ((0.400330, 0.431436, 0.453392), (0.246605, 0.246729, 0.256153)),
    'merl3000': ((0.478470, 0.503632, 0.507764), (0.230608, 0.228890, 0.232603)),
    'mpii': ((0.406822, 0.444257, 0.466048), (0.228944, 0.232618, 0.236498)),
    'se7en11': ((0.510878, 0.550169, 0.528517), (0.277175, 0.241594, 0.247830)),
    'synthetic': ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
}

# the reference's estimator.py:41-48 hard-coded values (the Estimator's
# strict_reference_stats mode)
ESTIMATOR_MEANSTD = {
    'coco': ((0.4003, 0.4314, 0.4534), (0.2466, 0.2467, 0.2562)),
    'mpii': ((0.4327, 0.4440, 0.4404), (0.2468, 0.2410, 0.2458)),
    'merl': ((0.4785, 0.5036, 0.5078), (0.2306, 0.2289, 0.2326)),
    'se7en11': ((0.5109, 0.5502, 0.5285), (0.2772, 0.2416, 0.2478)),
}


def get_meanstd(name: str):
    """Dataset statistics by substring match ('merl' matches merl3000).

    Unknown names fall back to the synthetic (0.5, 0.25) stats WITH a
    warning — a typo'd dataset silently mis-normalizing every input is
    exactly the failure mode this message exists to surface.
    """
    for key, v in MEANSTD.items():
        if key in name or name in key:
            return v
    import warnings
    warnings.warn(f'get_meanstd: no statistics for dataset {name!r}; '
                  'falling back to synthetic (0.5, 0.25)')
    return MEANSTD['synthetic']
