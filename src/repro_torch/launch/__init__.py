"""repro_torch.launch subpackage: command-line entry points."""
