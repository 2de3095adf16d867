"""repro_torch.distributed — sharding on ``torch.distributed``
(``sharding``: the reference's logical rules, resolved to ``DeviceMesh``
placements and ``DTensor``s; ``meshes``: Laminar's submesh carving) and
the training loop's fault tolerance (``fault_tolerance``). The dry run
places fake tensors on a fake 256- or 512-rank mesh
(``sharding.tree_shape_dtypes``, ``launch/mesh.py::make_production_mesh``)."""
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
