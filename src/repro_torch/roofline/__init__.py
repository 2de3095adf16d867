from repro_torch.roofline import hw  # noqa: F401
