"""repro_torch.data subpackage: the synthetic corpus and its batches."""
