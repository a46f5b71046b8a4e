"""The examples of the port (counterpart of the repo's ``examples/``):
``examples.imagenet`` holds the ResNet family and its amp training
script, ``examples.gpt`` the GPT scaling study and the fp8 training
example, ``examples.dcgan`` the amp DCGAN with three scaled losses and
``examples.simple.distributed`` the minimal data-parallel example."""
