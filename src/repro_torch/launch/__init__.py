"""Launchers of the port: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``; ``analysis`` holds the serving and
guidance summaries they print."""
