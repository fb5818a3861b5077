"""AdamW, the LR schedule and int8 gradient compression."""
from repro_torch.optim.adamw import AdamW, adamw  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    compress_grads_int8,
    decompress_grads_int8,
    init_residual,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
