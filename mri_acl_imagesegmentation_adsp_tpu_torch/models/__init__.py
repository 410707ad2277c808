"""Models of the port (the U-Nets, ConvNeXt) and their Flax converters."""
