"""The port's model zoo (dense, MoE and SSM decoder-only LMs)."""
from repro_torch.models.api import Model, build_model  # noqa: F401
