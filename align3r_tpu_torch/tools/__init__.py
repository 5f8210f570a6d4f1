"""Measurement scripts for the port, run on the card (``python -m
align3r_tpu_torch.tools.<name>``)."""
