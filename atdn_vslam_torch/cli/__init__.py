"""Command-line entry points (``python -m atdn_vslam_torch.cli.<name>``)."""
