"""The benchmark of the PyTorch/H100 port (``ape_x_dqn_tpu_torch``).

One run measures one cell of ``BENCHMARK.json``:

    python3 -m apex_bench.run --workload pong-learn --seed 7 \\
        --seconds 20 --trace 0

Everything a cell is made of is found by name: the configuration in
``configs/<config>.json`` (sizes as run; its ``adaptor`` key names the
module of ``adaptors/`` that builds the system under test and runs its
window), the traffic and the correctness limits in
``workloads/<cell>.json``, the FLOP and byte counts in
``costs/<config>.py``, each per-layer metric's reader in
``metrics/<metric>.py``, and the plain reference, with the comparison
that decides ``correct``, in the ``reference/`` module the adaptor
names. The yardstick (inputs from the seed, the references and their
comparisons, the counts and peaks, the readers) imports nothing of the
port; only the adaptors build the port's objects.
"""
