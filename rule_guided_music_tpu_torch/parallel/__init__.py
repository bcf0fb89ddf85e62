"""Parallelism of the port: the ("data", "fsdp", "model") device mesh and
its sharding rules (:mod:`.mesh`), differentiable collectives
(:mod:`.comm`) and the GPipe and circular pipelines (:mod:`.pipeline`)."""
