"""repro_torch.analysis: the Hopper cost table (``cost_model``)."""
