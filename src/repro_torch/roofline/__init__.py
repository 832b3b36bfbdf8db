"""Roofline analysis of the dry-run's traced cells on the H100."""
