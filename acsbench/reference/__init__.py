"""The plain reference: PyTorch operations in float32, written from the
configuration files. It imports nothing of the program under test."""
