"""The public engines (``Engine2d``, ``Engine3d``), the 3D finishes (stack
postprocessing and the ortho-plane consensus), configs, the model registry
and bundles, seeded models and preprocessing."""

from empanada_tpu_torch.api.config import merge_dicts, read_yaml
from empanada_tpu_torch.api.inference import (
    Engine2d,
    Engine3d,
    combine_panoptic_maps,
    instance_relabel,
    stack_postprocessing,
    tracker_consensus,
)
from empanada_tpu_torch.api.utils import (
    Preprocessor,
    add_new_model,
    get_configs,
    init_model_from_config,
    load_config,
    load_model_bundle,
    load_model_from_config,
    normalize,
    randomize_bn_stats,
    save_model_bundle,
)

__all__ = ["Engine2d", "Engine3d", "combine_panoptic_maps", "instance_relabel",
           "stack_postprocessing", "tracker_consensus", "Preprocessor", "add_new_model",
           "get_configs",
           "init_model_from_config", "load_config", "load_model_bundle",
           "load_model_from_config", "merge_dicts", "normalize", "randomize_bn_stats",
           "read_yaml", "save_model_bundle"]
