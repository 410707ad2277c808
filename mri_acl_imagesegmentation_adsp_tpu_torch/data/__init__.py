"""Data pipeline of the port: raw-data adapters, the preprocessing chain,
packs, the slice stores and the recon loaders."""
