"""Multi-device rendering and training over ``torch.distributed``
(counterpart of ``materialist_tpu/parallel/``): sample (spp) and
film-row (px) sharding of the production estimator, on a device mesh
over the process group the caller has started (``mesh.py``,
``sharding.py``), and a launcher of ranks with the four agreement
checks of the JAX package's multi-chip dry run (``dryrun.py``)."""
