from dhd_tpu_torch.train.compare import gradient_errors, zero_gradient_params
from dhd_tpu_torch.train.ema import ModelEMA
from dhd_tpu_torch.train.optim import AdamWSchedule, make_lr_schedule
from dhd_tpu_torch.train.step import eval_step, total_loss, train_step

__all__ = ["AdamWSchedule", "ModelEMA", "eval_step", "gradient_errors",
           "make_lr_schedule", "total_loss", "train_step",
           "zero_gradient_params"]
