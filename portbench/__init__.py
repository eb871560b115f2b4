"""The benchmark of the PyTorch/CUDA port (``qeft_tpu_torch``).

One command runs one cell once::

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's model on the card from the seed, warms up the cell's
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference under ``portbench/reference/``, and prints one
JSON line.  Cells, configurations, traffic mixes, limits and metrics are
files found by name (``README.md``).  Nothing here imports JAX or the JAX
package.
"""
