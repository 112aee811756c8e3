"""Multi-process execution: the mesh of ranks, bring-up, sharded scoring
and fit, and long-document sequence parallelism (``torch.distributed``)."""
