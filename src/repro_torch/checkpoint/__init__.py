from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    CheckpointMismatchError,
    all_steps,
    latest_step,
    restore,
    save,
)
