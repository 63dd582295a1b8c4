"""Architecture and shape configurations (the port's own copy)."""
