"""Distributed layers of the PyTorch port (single device for now)."""
