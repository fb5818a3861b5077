"""The plain references: fp32 PyTorch, no kernel, cache or batching, and
nothing of the program (`repro_torch`) imported."""
