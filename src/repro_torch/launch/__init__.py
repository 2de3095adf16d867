"""repro_torch.launch — the serving layer of the port (``serve``) and
the training driver (``train``)."""
