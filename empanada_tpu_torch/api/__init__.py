"""The public engines (``Engine2d``, ``Engine3d``), the 3D finishes (stack
postprocessing and the ortho-plane consensus), configs, the model registry,
bundles (int8 among them) and the URL cache, model archives, serving
artifacts, seeded models and preprocessing."""

from empanada_tpu_torch.api.config import merge_dicts, read_yaml
from empanada_tpu_torch.api.deploy import (
    ServingModel,
    export_serving_artifact,
    load_serving_artifact,
)
from empanada_tpu_torch.api.export import archive_model, export_model, import_model
from empanada_tpu_torch.api.inference import (
    Engine2d,
    Engine3d,
    combine_panoptic_maps,
    instance_relabel,
    stack_postprocessing,
    tracker_consensus,
)
from empanada_tpu_torch.api.utils import (
    MODEL_DIR,
    Preprocessor,
    add_new_model,
    cached_model_path,
    get_configs,
    init_model_from_config,
    load_config,
    load_model_bundle,
    load_model_from_config,
    normalize,
    randomize_bn_stats,
    requantize_bundle,
    save_model_bundle,
)

__all__ = ["Engine2d", "Engine3d", "combine_panoptic_maps", "instance_relabel",
           "stack_postprocessing", "tracker_consensus", "Preprocessor", "add_new_model",
           "get_configs", "init_model_from_config", "load_config",
           "load_model_bundle", "load_model_from_config", "merge_dicts", "normalize",
           "randomize_bn_stats", "read_yaml", "save_model_bundle", "requantize_bundle",
           "MODEL_DIR", "cached_model_path", "archive_model", "export_model",
           "import_model", "ServingModel", "export_serving_artifact",
           "load_serving_artifact"]
