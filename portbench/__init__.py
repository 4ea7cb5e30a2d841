"""The benchmark of the PyTorch and CUDA port, ``torch_m3gnet_tpu_torch``.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``harness.py`` says
how a cell is found by name. Nothing here imports JAX or the JAX package.
"""
