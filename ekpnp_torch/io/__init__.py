"""Host-side writers of the port (numpy)."""
