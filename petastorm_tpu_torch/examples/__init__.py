"""End-to-end examples of the port."""
