"""repro_torch.distributed — the training loop's fault tolerance
(``fault_tolerance``: the JAX package's module with its imports
rewritten). Sharding, meshes and collectives are not ported yet
(ROADMAP.md, queue 1, item 4)."""
