"""The loops that traffic mixes drive, one module per ``kind`` of
``traffic/<mix>.json``: ``setup``, ``window``, ``traced``, ``release`` and
``check`` (the numbers that decide ``correct``)."""
