"""Dense decoder model path of the port (layers, blocks, model)."""
