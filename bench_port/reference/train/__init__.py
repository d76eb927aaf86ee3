from bench_port.reference.train.ema import ModelEMA
from bench_port.reference.train.optim import AdamWSchedule, make_lr_schedule
from bench_port.reference.train.step import total_loss, train_step

__all__ = ["AdamWSchedule", "ModelEMA", "make_lr_schedule", "total_loss",
           "train_step"]
