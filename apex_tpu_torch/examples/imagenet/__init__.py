"""ImageNet ResNet training with amp (counterpart of
``examples/imagenet``): ``resnet`` (the model over a parameter tree with
the flax key paths) and ``main_amp`` (the training script)."""
