"""Optimizers of the port: Adam and SGD with their learning-rate
schedules (``adam``)."""
