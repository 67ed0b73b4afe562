"""Distribution: gradient sync across ranks, and the async actor/learner runner.

* `repro_torch.distributed.collective` — `pmean` (the counterpart of
  ``jax.lax.pmean``) over the process group a ``distributed_axis`` name
  is bound to, and `run_world`, the spawned world the sharded runner
  (`repro_torch.core.system.train_distributed`) runs its ranks in;
* `repro_torch.distributed.impala` — the IMPALA-style async
  actor/learner runner (`make_async` / `train_async`);
* `repro_torch.distributed.sharding` — the reference's logical-axis rules
  (`repro.distributed.sharding`) over a `DeviceMesh`: specs, DTensor
  placements, `with_logical_constraint`, and the sharded calls the LM runs
  on DTensors (`einsum`, the vocab-parallel lookups, `local_call`); the
  async runner constrains its actor state to the table's ``actors`` rule
  (`impala._shard_actors`).
"""
