"""LO-BCQ numerics of the port: number formats, encode/decode, PTQ."""
