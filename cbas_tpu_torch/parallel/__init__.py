"""Device meshes for cbas_tpu_torch: data and tensor parallelism in one process."""
