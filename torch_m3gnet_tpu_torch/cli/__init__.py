"""Command-line entry points of the port: ``train_mlearn`` and
``train_mpf`` (console scripts ``m3gnet-torch-train-mlearn`` and
``m3gnet-torch-train-mpf``)."""
