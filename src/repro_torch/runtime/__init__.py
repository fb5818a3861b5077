"""The fault-tolerant training runner."""
from repro_torch.runtime.trainer import (  # noqa: F401
    StragglerMonitor,
    StragglerReport,
    TrainRunner,
)
