"""Knowledge-graph data (host side, numpy): see ``data/kg.py``."""
