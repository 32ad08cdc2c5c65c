"""REST API of the port."""
