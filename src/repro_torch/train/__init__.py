"""Persistence (``checkpoint.py``); the training loop comes with the
training slice."""
