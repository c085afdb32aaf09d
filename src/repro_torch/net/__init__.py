"""Machine descriptions and the event simulator (stack path)."""
