from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    restore_pytree,
    restore_update_store,
    save_pytree,
    save_update_store,
)
