"""Command-line entry points of the port, each with ``main(argv=None)`` and
``--device`` (default: the card): ``train_mlearn``, ``train_mpf``
(console scripts ``m3gnet-torch-train-mlearn``, ``m3gnet-torch-train-mpf``),
``relax``, ``md``, ``bessel_zeros`` (``m3gnet-torch-relax``,
``m3gnet-torch-md``, ``m3gnet-torch-bessel-zeros``; ``bessel_zeros`` needs
no card and takes no ``--device``), ``predict`` and ``elastic`` (``python -m``)."""
