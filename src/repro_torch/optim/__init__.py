"""AdamW, its schedule and gradient accumulation, on trees of tensors."""
from repro_torch.optim.accumulate import GradAccumulator
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     apply_updates, clip_by_global_norm,
                                     linear_warmup_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "apply_updates",
           "clip_by_global_norm", "linear_warmup_schedule", "GradAccumulator"]
