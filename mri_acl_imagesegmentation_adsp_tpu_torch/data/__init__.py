"""Data pipeline of the port: the preprocessing chain."""
