"""Tree checkpoints: flattened-path npz + json metadata."""
from repro_torch.checkpoint.store import latest_step, load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree", "latest_step"]
