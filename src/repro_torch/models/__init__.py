from repro_torch.models.registry import family_module, model_api  # noqa: F401
