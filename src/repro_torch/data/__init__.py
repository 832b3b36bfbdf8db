"""Knowledge-graph data: the host side in numpy and the device pipeline's
batching in torch; see ``data/kg.py``."""
