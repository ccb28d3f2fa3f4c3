"""Training of the port: AdamW with the cosine schedule, the synthetic
multimodal data, sharded npz checkpoints and the host loop (port of
``repro.training``; gradients through the flash kernel's backward on the
card)."""
from repro_torch.training.optimizer import (
    OptimizerConfig, adamw_init, adamw_update, cosine_lr, global_norm)
from repro_torch.training.data import SyntheticDataConfig, synthetic_batches
from repro_torch.training.checkpoint import save_checkpoint, load_checkpoint
from repro_torch.training.loop import TrainState, make_train_step, train_loop
