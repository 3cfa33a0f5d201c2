"""Runtime utilities the serving engine needs: metrics, tracing,
failpoints and step anatomy, the port's own copies of the parts of
``ray_tpu/util`` it calls (their registries are this package's own)."""
