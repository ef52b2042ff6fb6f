"""Training layer (counterpart of ``empanada_tpu/train``): losses, the
train state and steps, metrics, and the config-driven loop."""

from empanada_tpu_torch.train.loop import (
    finetune_main,
    freeze_encoder_mask,
    load_checkpoint,
    main,
    save_checkpoint,
    validate,
)
from empanada_tpu_torch.train.losses import (
    BCLoss,
    PanopticLoss,
    bootstrap_ce,
    heatmap_mse,
    offset_l1,
    point_rend_loss,
)
from empanada_tpu_torch.train.metrics import F1, PQ, AverageMeter, ComposeMetrics, EMAMeter, IoU
from empanada_tpu_torch.train.state import (
    TrainState,
    adamw_with_decay_mask,
    create_train_state,
    make_eval_step,
    make_train_step,
    onecycle_schedule,
)

__all__ = [
    "validate", "BCLoss", "PanopticLoss", "bootstrap_ce", "heatmap_mse", "offset_l1",
    "point_rend_loss", "TrainState", "adamw_with_decay_mask", "create_train_state",
    "make_eval_step", "make_train_step", "onecycle_schedule", "finetune_main",
    "freeze_encoder_mask", "load_checkpoint", "main", "save_checkpoint",
    "F1", "PQ", "AverageMeter", "ComposeMetrics", "EMAMeter", "IoU",
]
