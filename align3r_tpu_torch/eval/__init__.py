"""Scene writers and trajectory metrics (port of align3r_tpu/eval)."""
