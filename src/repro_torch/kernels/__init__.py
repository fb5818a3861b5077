"""Hand-written Hopper kernels, their plain PyTorch versions and the
wrappers that pick between them by device (`repro_torch.kernels.ops`)."""
