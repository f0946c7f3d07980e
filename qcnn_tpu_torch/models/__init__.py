"""Model specs, synthetic parameters, preparation and the forward pass."""
