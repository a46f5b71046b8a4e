"""The GPT scaling study (counterpart of ``examples/gpt``):
``gpt_scaling_test`` times train steps over a ladder of model sizes,
with and without the ``cpu_offload`` of ``save_on_cpu``."""
