from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step  # noqa: F401
