"""Models of the port: the ResNet-encoder U-Net and its Flax converter."""
