"""The examples of the port (counterpart of the repo's ``examples/``):
``examples.imagenet`` holds the ResNet family and its amp training
script."""
