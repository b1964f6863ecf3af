"""Command-line scripts of the port, run with `python -m multimodalstudio_tpu_torch.scripts.<name>`."""
