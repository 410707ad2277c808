"""Small helpers of the port: device selection, input norm, synthetic data."""
