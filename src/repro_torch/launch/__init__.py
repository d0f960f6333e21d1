"""repro_torch.launch — entry points (serving so far)."""
