"""The port's command-line entries: the demo (``python -m
align3r_tpu_torch.tools.demo``) and the measurement scripts run on the card
(``python -m align3r_tpu_torch.tools.<name>``)."""
