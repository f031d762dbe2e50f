from repro_torch.models.model import (  # noqa: F401
    forward,
    init_cache,
    init_params,
    make_loss_fn,
    write_slot,
)
