"""Model stack of the port: config, layers, the Mamba-2 block, the LM."""
