"""Architecture configurations of the port (``get_config`` by name)."""
