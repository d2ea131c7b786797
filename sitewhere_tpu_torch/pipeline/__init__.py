"""Host-side feed path of the scoring flush."""
