"""Training several replicas at once (port of ``mpmc_tpu/parallel``): the
fold-parallel step on one device.  The mesh layouts (data, model, pipeline
and sequence shards) are not ported yet."""
