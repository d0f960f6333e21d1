"""repro_torch.launch — entry points: serving and training."""
