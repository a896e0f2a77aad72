"""Drivers of the port (serving now; training with its slice)."""
