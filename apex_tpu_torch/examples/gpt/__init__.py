"""The GPT examples (counterpart of ``examples/gpt``):
``gpt_scaling_test`` times train steps over a ladder of model sizes,
with and without the ``cpu_offload`` of ``save_on_cpu``;
``fp8_training`` trains a small GPT on the fp8 delayed-scaling recipe."""
