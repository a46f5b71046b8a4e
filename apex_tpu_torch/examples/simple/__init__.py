"""The simple examples (counterpart of ``examples/simple``):
``distributed.distributed_data_parallel`` trains one linear layer with
amp O1 and ``DistributedDataParallel``."""
