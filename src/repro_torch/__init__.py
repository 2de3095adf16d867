"""repro_torch — the PyTorch and CUDA port of the Hydro reproduction.

It mirrors the layout of the JAX package ``repro`` (``core/``,
``kernels/``, ``udfs/``, ``roofline/``, ``data/``, ``configs/``,
``models/``, ``optim/``, ``checkpoint/``, ``distributed/``, ``launch/``,
``examples/``) and imports neither JAX nor ``repro``: the framework-free
core is a copy.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
