"""repro_torch.distributed — sharding on ``torch.distributed``
(``sharding``: the reference's logical rules, resolved to ``DeviceMesh``
placements and ``DTensor``s; ``meshes``: Laminar's submesh carving) and
the training loop's fault tolerance (``fault_tolerance``). The dry run's
fake 256/512-rank meshes wait for slice 17 (ROADMAP.md)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    TRAIN_RULES,
    SERVE_RULES,
    Rules,
    axis_size,
    batch_axes,
    constrain,
    distribute,
    placements_for,
    spec_for,
)
