"""Data and sequence parallelism over ``torch.distributed`` (counterpart of
``pairnet_tpu/parallel``): ``mesh`` for process groups and the
data-parallel collectives, ``spatial`` for the sequence-parallel deformable
encoder."""
