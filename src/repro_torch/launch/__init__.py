"""Launchers: ``python -m repro_torch.launch.serve`` serves a model from
wire bytes streamed through a simulated link (see :mod:`.serve`)."""
