from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, cosine_lr, from_reference,
    global_norm,
)
