"""Device ops: resize, decode; Hopper kernels under `hopper/`."""
