"""Dense decoder of the port: layers, transformer, zoo, weight bridge."""
