"""Runtime utilities, the port's own copies of the parts of
``ray_tpu/util`` it calls (their registries are this package's own): for
the serving engine metrics, tracing, failpoints and step anatomy; for the
trainer the session's cost model (``xla_cost``), goodput, device
telemetry, placement groups, scheduling strategies and the actor-backed
queue; for the data library the actor pools (``actor_pool``) and the
input pipeline's half of metrics and goodput."""
