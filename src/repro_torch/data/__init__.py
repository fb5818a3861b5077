"""The synthetic-LM data pipeline."""
from repro_torch.data.pipeline import BOS, SyntheticLM, make_batch  # noqa: F401
