"""Tensor ops of the port: colour, fixed point, vertices, surfaces, raster."""
