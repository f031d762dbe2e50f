from repro_torch.training.optimizer import AdamW, AdamWState  # noqa: F401
