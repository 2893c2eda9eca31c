"""Command-line tools of the port (``python -m mhim_mil_torch.tools.<name>``)."""
