"""repro_torch.checkpoint subpackage: the npz checkpoint store."""
