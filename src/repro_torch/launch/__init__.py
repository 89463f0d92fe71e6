"""Launchers of the port: ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve`` and the dry run,
``python -m repro_torch.launch.dryrun``; ``mesh`` builds the production
and test meshes; ``analysis`` holds the cost walk and the serving and
guidance summaries."""
