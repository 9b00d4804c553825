from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    global_norm,
    make_lr_schedule,
)
