"""Checkpoint I/O of the port (counterpart of ``repro/checkpoint``)."""
