"""Config loading, seeded models and preprocessing."""

from empanada_tpu_torch.api.utils import (
    Preprocessor,
    init_model_from_config,
    load_config,
    normalize,
    randomize_bn_stats,
)

__all__ = ["Preprocessor", "init_model_from_config", "load_config", "normalize",
           "randomize_bn_stats"]
