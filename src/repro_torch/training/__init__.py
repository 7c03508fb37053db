"""Training substrate: AdamW, microbatched train step, grad compression."""
from repro_torch.training.optimizer import (AdamW, AdamWState, global_norm,
                                            lr_schedule)
from repro_torch.training.train_step import default_schedule, make_train_step
from repro_torch.training.compression import compress_int8, decompress_int8

__all__ = ["AdamW", "AdamWState", "global_norm", "lr_schedule",
           "make_train_step", "default_schedule", "compress_int8",
           "decompress_int8"]
