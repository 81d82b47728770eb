"""Dataset writing and footer metadata of the port."""
