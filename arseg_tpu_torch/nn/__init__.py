"""Neural-network modules of the port (NCHW, reference state-dict keys)."""
