"""Process-wide runtime state and option validation (port of
``ray_tpu/_private``: ``worker`` and ``options`` only)."""
