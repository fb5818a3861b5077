"""The port's model zoo (dense and MoE decoder-only LMs)."""
from repro_torch.models.api import Model, build_model  # noqa: F401
