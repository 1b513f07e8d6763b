"""Host-side utilities of the port: synthetic scenes, trajectory metrics."""
