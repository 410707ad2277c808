"""Probes run by hand on the card; no entry point of the port imports them."""
