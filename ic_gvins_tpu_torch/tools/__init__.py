"""Command-line tools of the port (``python -m ic_gvins_tpu_torch.tools.<name>``)."""
