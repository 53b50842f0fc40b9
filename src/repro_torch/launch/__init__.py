"""Launchers: ``python -m repro_torch.launch.serve`` serves a model from
wire bytes streamed through a simulated link (see :mod:`.serve`);
``python -m repro_torch.launch.train`` trains one and saves progressive
checkpoints (see :mod:`.train`)."""
