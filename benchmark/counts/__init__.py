"""The yardstick's arithmetic: the card's peaks, the models' FLOPs and the
mask kernels' least times, fixed here whatever implements them."""
