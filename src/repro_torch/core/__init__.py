"""LO-BCQ numerics of the port: number formats, encode/decode, the codebook
fit and calibration, the baseline quantizers, PTQ."""
