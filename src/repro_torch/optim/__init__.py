from repro_torch.optim.adamw import AdamW, Adafactor, cosine_schedule, constant_schedule  # noqa: F401
from repro_torch.optim.compression import Int8ErrorFeedback  # noqa: F401
