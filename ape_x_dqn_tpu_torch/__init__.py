"""Ape-X DQN in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

The PyTorch counterpart of ``ape_x_dqn_tpu``, built slice by slice with
the JAX package as its reference: the module tree and names mirror it
(``ape_x_dqn_tpu_torch/replay/frame_ring.py`` <->
``ape_x_dqn_tpu/replay/frame_ring.py``), and tests/test_torch_*.py hold
each module against its counterpart on the same numpy-seeded inputs.

The package imports torch and numpy, never jax, flax, optax or
``ape_x_dqn_tpu``. Entry points default to ``device="cuda"`` and raise
when CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels (what the CPU tests do).

Ported so far:
- the ``pong`` prioritized frame-ring learner cycle
  (``runtime/build.py: build_learner``), with the frame-row gather as a
  hand-written CUDA kernel (``ops/frame_gather.py``, ``csrc/``);
- the single-process trainer (``runtime/single_process.py:
  train_single_process`` and ``python -m
  ape_x_dqn_tpu_torch.runtime.train --single-process``): environments,
  n-step folding, flat prioritized and uniform replay (packed pixel rows
  gathered by the same kernel), the K-batch and prefetch learner paths;
- the Ape-X driver (``runtime/driver.py: ApexDriver``, the CLI's default
  mode) on one card: actors in threads, the batched inference server,
  ingest staging and the learner;
- the R2D2 family through that driver: the LSTM Q-net, stored-state
  sequence replay, the burn-in sequence loss and ``SequenceLearner``,
  recurrent actors and the recurrent eval.
"""

# the version log_run_header stamps into every run's JSONL (the JAX
# package's, whose run records the port's mirror)
__version__ = "0.2.0"
