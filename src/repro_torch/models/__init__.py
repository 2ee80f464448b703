"""Model stack: layers, attention, dense blocks, params, split programs."""
