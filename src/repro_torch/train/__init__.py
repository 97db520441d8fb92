"""repro_torch.train subpackage: the loss and the train step."""
