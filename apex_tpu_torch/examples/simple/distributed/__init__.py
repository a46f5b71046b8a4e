"""The minimal amp + ``DistributedDataParallel`` example (counterpart of
``examples/simple/distributed``)."""
