"""repro_torch.launch — the serving layer of the port (``serve``)."""
