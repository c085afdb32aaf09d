"""Parameter tables, torus topology and the model ladder (stack path)."""
