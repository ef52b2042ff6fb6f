"""Config loading, seeded models and preprocessing, and the 3D finishes
(stack postprocessing and the ortho-plane consensus)."""

from empanada_tpu_torch.api.inference import (
    instance_relabel,
    stack_postprocessing,
    tracker_consensus,
)
from empanada_tpu_torch.api.utils import (
    Preprocessor,
    init_model_from_config,
    load_config,
    normalize,
    randomize_bn_stats,
)

__all__ = ["Preprocessor", "init_model_from_config", "load_config", "normalize",
           "randomize_bn_stats", "instance_relabel", "stack_postprocessing",
           "tracker_consensus"]
