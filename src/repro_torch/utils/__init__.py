"""Analysis utilities (the port of ``repro.utils``): ``collectives`` counts
the collectives a sharded program issues, in place of the reference's HLO
parsers ``hlo`` and ``hlo2``.  The reference's ``compat`` (jax-version
shims: the ambient mesh, ``shard_map``, ``cost_analysis``'s list-or-dict
return) has no counterpart: the port passes its mesh to the step, uses
``torch.distributed`` groups and counts FLOPs with ``FlopCounterMode``'s
formulas."""
