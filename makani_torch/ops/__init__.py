"""Spectral ops of the port: quadrature and Legendre tables (numpy), the
channels-last real DFT and the spherical harmonic transforms."""
