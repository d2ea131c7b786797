"""Device ops of the port (ring-buffer windows)."""
