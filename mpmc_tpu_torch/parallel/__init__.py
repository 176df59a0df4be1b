"""Training over several processes and replicas (port of
``mpmc_tpu/parallel``): the process mesh (``mesh``, ``distributed``,
``dist_worker``), the collectives with their gradients (``collectives``),
data, tensor (``tp``), pipeline (``pp``) and sequence (``sp``)
parallelism, and fold-parallel training (``fold_parallel``)."""
