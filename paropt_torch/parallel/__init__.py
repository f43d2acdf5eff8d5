"""Device meshes and sharded state (counterpart of paropt_tpu/parallel)."""
