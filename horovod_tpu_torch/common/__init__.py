"""Process-group state and collectives of the port."""
