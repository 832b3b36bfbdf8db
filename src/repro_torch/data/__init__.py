"""Data: the knowledge graph (the host side in numpy and the device
pipeline's batching in torch; ``data/kg.py``) and the deterministic
synthetic token pipeline of the LM zoo (``data/tokens.py``)."""
