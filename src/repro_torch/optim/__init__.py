"""repro_torch.optim subpackage: AdamW, updated in place."""
