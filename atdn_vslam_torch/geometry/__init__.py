"""SE(3) pose math."""
